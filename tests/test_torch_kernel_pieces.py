"""The slab kernel's knock-out builds against scripts/time_kernel_pieces.py
and scripts/bisect_mosaic.py.

The scripts read spaln_tpu/ops/dp_spliced_pallas.py at import (and write
their variants to a scratch directory) by fixed paths: they are loaded
here from a copy whose paths name this checkout and the test's own
temporary directory.  Checked: the variant tables of
spaln_tpu_torch.probes.time_kernel_pieces and bisect_mosaic cover every
variant of both scripts (bisect_mosaic's four _cut_body cuts too), each
mapped to a build of csrc/spliced_dp.cu or to a stated "no counterpart";
which variants' patterns no longer occur in today's dp_spliced_pallas.py
(pinned); every build's nvcc defines give a build tag of its own, in the
order of the kernel's knock-out enum; and the "orig" build on
bisect_mosaic's batch, as the port's plain version (the CPU runs no
knock-out), gives the JAX script's own "orig" scores, run in Pallas's
TPU interpret mode and reduced by spaln_tpu's collect_batch_results.
"""
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from spaln_tpu_torch.ops import dp_spliced as dp
from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.probes import ablate_pallas as AB
from spaln_tpu_torch.probes import bisect_mosaic as BM
from spaln_tpu_torch.probes import time_kernel_pieces as TKP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT_MARKERS = ("---- recurrence", "---- acceptor close", "---- donor push",
               "h_out = jnp.where(active, h_out, NEV)")


def _script(name: str, tmp) -> object:
    """scripts/<name>.py with its checkout and scratch paths mapped."""
    src = open(os.path.join(ROOT, "scripts", f"{name}.py")).read()
    root = re.search(r'pathlib\.Path\("(.*)/spaln_tpu/ops/'
                     r'dp_spliced_pallas\.py"\)', src).group(1)
    scratch = re.search(r'pathlib\.Path\(f"(.*)/dp[tv]_\{name\}\.py"\)',
                        src).group(1)
    assert src.count(f'"{root}') == 2          # sys.path and SRC
    src = src.replace(f'"{root}', f'"{ROOT}')
    src = src.replace(f'f"{scratch}/', f'f"{tmp}/')
    path = tmp / f"{name}.py"
    path.write_text(src)
    spec = importlib.util.spec_from_file_location(f"_pieces_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pieces")
    return _script("time_kernel_pieces", tmp), _script("bisect_mosaic", tmp)


def _stale(script, subs) -> bool:
    if isinstance(subs, tuple):                  # a _cut_body cut
        return not all(m in script.SRC for m in CUT_MARKERS)
    return any(old not in script.SRC for old, _ in subs)


def test_tables_cover_every_variant(scripts):
    tkp, bis = scripts
    assert set(TKP.VARIANTS) == set(tkp.VARIANTS)
    assert set(BM.VARIANTS) == set(bis.VARIANTS) | set(BM.CUTS)
    assert BM.CUTS == ("min_body", "recur_only", "recur_close",
                       "recur_push")
    for mod in (TKP, BM):
        for v, build in mod.VARIANTS.items():
            if build is None:
                assert mod.NO_COUNTERPART[v]
            elif build != "tiling":
                assert build in AB.BUILDS, (v, build)
        assert set(mod.NO_COUNTERPART) == {
            v for v, b in mod.VARIANTS.items() if b is None}
    # a variant of both scripts maps to one build
    assert TKP.VARIANTS["no_close"] == BM.VARIANTS["no_close"] == "noclose"
    assert TKP.VARIANTS["full"] == BM.VARIANTS["orig"] == "none"


def test_stale_patterns_are_pinned(scripts):
    """Which variants' patterns today's dp_spliced_pallas.py no longer
    holds: the scripts print FAILED ("pattern missing") for those."""
    tkp, bis = scripts
    assert {v for v, subs in tkp.VARIANTS.items()
            if _stale(tkp, subs)} == TKP.STALE
    cuts = {c: ("CUT", {}) for c in BM.CUTS}
    assert {v for v, subs in {**bis.VARIANTS, **cuts}.items()
            if _stale(bis, subs)} == BM.STALE
    assert "full" not in TKP.STALE and "orig" not in BM.STALE


def test_builds_have_tags_of_their_own():
    """Each SLAB_ABLATE value its own library, none the production one's;
    BUILDS in the order of the kernel's enum."""
    tags = {K.build_tag(K.SOURCE, AB.defines(b)) for b in AB.BUILDS}
    assert len(tags) == len(AB.BUILDS) == 18
    assert K.build_tag(K.SOURCE) not in tags
    src = K.SOURCE.read_text()
    enum = re.search(r"enum \{ (ABL_NONE[^}]*)\}", src).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names == [f"ABL_{b.upper()}" for b in AB.BUILDS]
    assert AB.BUILDS[:len(AB.KNOCKOUTS)] == AB.KNOCKOUTS
    assert AB.defines("all_off_noedge") == ("SLAB_ABLATE=17",)
    assert AB.builds_of(["full", "no_tail", "chunk512", "no_close"],
                        TKP.VARIANTS) == ["none", "noclose"]
    assert AB.builds_of(list(BM.VARIANTS), BM.VARIANTS)[0] == "none"


def test_orig_scores_equal_the_scripts(scripts):
    """bisect_mosaic's batch: the script's "orig" variant (its main, with
    its loader patched to keep the run) in interpret mode, against the
    port's production step as its plain version."""
    from spaln_tpu.ops.dp_spliced_scan import collect_batch_results
    _, bis = scripts
    runs = []
    load = bis.load_variant

    def keep(name, subs):
        mod = load(name, subs)
        run = mod.run_spliced_batch_pallas

        def recorded(bp, prm, **kw):
            out = run(bp, prm, **kw)
            runs.append((bp, prm, out))
            return out
        mod.run_spliced_batch_pallas = recorded
        return mod

    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(sys, "argv", ["bisect_mosaic.py", "orig"])
        mp.setattr(bis, "load_variant", keep)
        bis.main()
    (jbp, jprm, (row, rc, _)), = runs
    want, _, _ = collect_batch_results(jbp, row, rc, None, True, prm=jprm)
    bp, prm = BM.bisect_batch("cpu")
    assert (bp.B, bp.Mpad, bp.W, bp.L) == (8, 128, 512, 128)
    got, _, _ = dp.collect_batch_results(bp, prm,
                                         *K.spliced_slab_score(bp, prm))
    assert np.array_equal(got, np.asarray(want))
    assert (got > 0).all()
