"""The step skeletons' plain versions against scripts/mosaic_repro.py:
the levels of its default kernel (mosaic_repro.py:449; the others are in
test_torch_mosaic_repro_whole.py).

Every level the script distinguishes there, and two it folds into level
0, runs through the script's own build(level) in Pallas's TPU interpret
mode on the CPU (``force_tpu_interpret_mode``) on the inputs its main
draws from default_rng(0), at its B = 16, and
spaln_tpu_torch.probes.mosaic_repro's plain version must give the same
four outputs: tolerance 0 (int32 throughout).  Levels 1-4 and 6-8 read
the stack tile and the fills block in 3-D, which the script's BlockSpecs
do not hand them: they run against a copy of the script with those reads
reshaped, made here by text substitution, each pattern asserted where it
is expected.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spaln_tpu_torch.probes import mosaic_repro as MR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "mosaic_repro.py")
VIEWS = (1, 2, 3, 4, 6, 7, 8)          # the levels written for 3-D reads
V = ".reshape(SOP, GRP, 128)"
# (pattern, its replacement, its count, the level headers it sits under)
SUBS = [
    ("jnp.concatenate([stk_ref[q], stk_ref[q + 1]],\n"
     "                                      axis=2)",
     f"jnp.concatenate([stk_ref[q]{V}, stk_ref[q + 1]{V}],\n"
     "                                      axis=2)",
     2, ("if level in (1, 6):", "if level == 8:")),
    ("pltpu.roll(stk_ref[q], -r, 2)", f"pltpu.roll(stk_ref[q]{V}, -r, 2)",
     1, ("if level == 7:",)),
    ("fl = fills_ref[c]\n", "fl = fills_ref[c].reshape(3, GRP, CHUNK)\n",
     1, ("def chunk_body(c, dp_carry):",)),
]


def _load(path: str, name: str, B: int):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.nblk = B, B // mod.GRP        # the script's REPRO_B
    return mod


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """The script as it is, and its copy with the 3-D reads."""
    src = open(SCRIPT).read()
    views = src
    for old, new, count, headers in SUBS:
        at = [i for i in range(len(src)) if src.startswith(old, i)]
        assert len(at) == count, old
        for i, header in zip(at, headers):
            h = src.rfind(header, 0, i)
            assert h >= 0 and src.count("\n", h, i) <= 6, (old, header)
        views = views.replace(old, new)
    path = tmp_path_factory.mktemp("mosaic") / "mosaic_repro_views.py"
    path.write_text(views)
    return SCRIPT, str(path)


def _outputs(path: str, level: int, B: int, inp: dict) -> list:
    mod = _load(path, f"_mosaic_{abs(hash(path))}_{B}", B)
    with pltpu.force_tpu_interpret_mode():
        out = mod.build(level)(*[np.asarray(x)
                                 for x in inp["args"].values()])
        return [np.asarray(o) for o in out]


def test_inputs_are_the_scripts():
    """main()'s draws (build patched to record them, jit a no-op)."""
    mod = _load(SCRIPT, "_mosaic_main", 16)
    seen = []

    def build(level):
        def call(*arrays):
            seen.append((level, [np.asarray(x) for x in arrays]))
            return [np.zeros(1)]
        return call

    class _Jax:
        jit = staticmethod(lambda f: f)

        def __getattr__(self, k):
            return getattr(mod.jax, k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [SCRIPT, "0", "50"])
        mp.setattr(mod, "build", build)
        mp.setattr(mod, "jax", _Jax())
        mod.main()
    inp = MR.inputs(16)
    for (level, arrays), key in zip(seen, ("args", "args50")):
        want = list(inp[key].values())
        assert len(arrays) == len(want)
        for x, y in zip(arrays, want):
            assert x.dtype == np.int32 and np.array_equal(x, y), level


@pytest.mark.parametrize("level", [lev for lev in MR.LEVELS if
                                   MR.kernel_of(lev) == "default"]
                         + [13, 29])
def test_level_equals_script(scripts, level):
    B = 16
    inp = MR.inputs(B)
    path = scripts[1] if MR.instance(level) in VIEWS else scripts[0]
    want = _outputs(path, level, B, inp)
    got = MR.run(level, MR.level_inputs(level, inp, "cpu"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)


def test_wrapper_takes_cpu_tensors_only_as_plain():
    """A CPU tensor runs the plain version and counts no launch; a level
    the kernel cannot take raises before any launch."""
    MR.reset_counts()
    a = MR.level_inputs(0, MR.inputs(8, 2), "cpu")
    out = MR.run(0, a, 2)
    assert [tuple(o.shape) for o in out] == [(8, 256)] * 4
    assert not MR.launches
    with pytest.raises(ValueError, match="chunks >= 3"):
        MR.run(11, MR.level_inputs(11, MR.inputs(8, 2), "cpu"), 2)
