"""The step skeletons' plain versions against scripts/mosaic_repro.py:
the levels of its level >= 32 kernel (mosaic_repro.py:265) and of level
50's (93); test_torch_mosaic_repro.py has the default kernel's.

Every level the script distinguishes there, and three it folds into
level 33, runs through the script's own build(level) in Pallas's TPU
interpret mode on the CPU (``force_tpu_interpret_mode``) on the inputs
its main draws from default_rng(0), and
spaln_tpu_torch.probes.mosaic_repro's plain version must give the same
four outputs: tolerance 0 (int32 throughout; memory the kernel never
writes, at levels 36 and 46, holds INT32_MAX in both, as interpret mode
fills it).  Levels 32-46 run at B = GRP = 8 (the script's whole-array
blocks take no other B), level 50 at the script's B = 16.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spaln_tpu_torch.probes import mosaic_repro as MR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "mosaic_repro.py")


def _script(B: int):
    spec = importlib.util.spec_from_file_location(f"_mosaic_{B}", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.nblk = B, B // mod.GRP        # the script's REPRO_B
    return mod


@pytest.mark.parametrize("level", [lev for lev in MR.LEVELS if
                                   MR.kernel_of(lev) != "default"]
                         + [39, 47, 51])
def test_level_equals_script(level):
    B = 16 if level == 50 else MR.GRP
    inp = MR.inputs(B)
    a = inp["args50"] if level == 50 else inp["args"]
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(o) for o in _script(B).build(level)(
            *[np.asarray(x) for x in a.values()])]
    got = MR.run(level, MR.level_inputs(level, inp, "cpu"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)
    if level in (36, 46):         # what the kernel leaves alone
        assert (got[1] == MR.UNWRITTEN).all()


def test_levels_32_to_46_take_b_8_only():
    inp = MR.inputs(16)
    for level in (32, 39, 46):
        with pytest.raises(ValueError, match="B must be GRP"):
            MR.plain(level, MR.level_inputs(level, inp, "cpu"))
    assert MR.instance(39) == MR.instance(48) == 33
    assert MR.instance(20) == 0 and MR.instance(50) == 50
