"""Per-query failure isolation.

The reference skips a malformed/failed query with a warning and keeps the
run alive (spaln.cc:1104-1107 `prompt(...); continue`, all_in_func IS_ERR
continue).  In a batched runtime the same contract matters more: one bad
record must not abort a whole device batch, let alone the run.

`guard_query` wraps one query's host-side work; on failure it logs the
query name + exception to stderr, bumps the `skipped_queries` metric and
returns the fallback value.  KeyboardInterrupt/SystemExit and
DeviceDPError always propagate: a failed DP build, launch or traceback
stops the run instead of quietly losing a result.
"""
from __future__ import annotations

import sys
import traceback

from .metrics import metrics


class QuerySkipped(Exception):
    """Raised internally to mark a query as deliberately skipped."""


class DeviceDPError(RuntimeError):
    """The banded DP (kernel build or launch, its plain version, the UDH
    backwalk) failed for a query; never isolated per query."""


def report_skip(name: str, exc: BaseException, stage: str = "") -> None:
    metrics.bump("skipped_queries")
    where = f" [{stage}]" if stage else ""
    print(f"spaln_tpu: skipping query '{name}'{where}: "
          f"{type(exc).__name__}: {exc}", file=sys.stderr)
    if metrics.counters.get("skipped_queries", 0) <= 3:
        traceback.print_exc(file=sys.stderr)


def guard_query(fn, *args, name: str = "", stage: str = "",
                fallback=None, **kwargs):
    """Run fn(*args, **kwargs); on error report + return fallback."""
    try:
        return fn(*args, **kwargs)
    except (KeyboardInterrupt, SystemExit, DeviceDPError):
        raise
    except BaseException as exc:             # noqa: BLE001 — isolation point
        report_skip(name, exc, stage)
        return fallback
