"""Milliseconds a query of the ``align`` entry that no program span
covers: the queries' walls (the benchmark's spans) less the output (the
benchmark's span around ``emit``) and the program's ``seed``, ``prep``,
``device_dp`` and ``traceback`` spans (``init_row`` lies inside
``prep``), in an ``align`` cell of a traced run whose program opens
those spans."""

TOP = ("seed", "prep", "device_dp", "traceback")


def read(run):
    t = run["trace"]
    if (run["entry"] != "align" or t is None
            or not any(k in t["stage_s"] for k in TOP)):
        return None
    staged = sum(t["stage_s"].get(k, 0.0) for k in TOP)
    return 1e3 * (sum(run["query_s"]) - run["output_s"] - staged) / run["n"]
