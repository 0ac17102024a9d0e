"""The port's `sortgrcd` against spaln_tpu: both CLIs map
tests/test_torch_map.py's planted corpus with -O12 (the port's DP on the
CPU), the two .grd.npz shards hold equal arrays, and both CLIs' sortgrcd
print byte-identical text over them, for each output form, filter preset,
chromosome order and threshold case."""
import numpy as np
import pytest
import torch

from spaln_tpu import cli as ref_cli
from spaln_tpu_torch import cli as port_cli

from test_torch_map import _index, _map, planted  # noqa: F401 (fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is small tensors a step: one intra-op
    thread runs it faster than many, and keeps the file's time under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shards(planted, tmp_path_factory):  # noqa: F811
    """(dir, ref shard, port shard): each package indexes the corpus and
    maps it with -O 0,12 (spaln_tpu on its plane path, SPALN_UDH=0)."""
    d = planted
    mp = pytest.MonkeyPatch()
    mp.setenv("SPALN_UDH", "0")
    try:
        for main, db, extra in ((ref_cli.main, "ref", ()),
                                (port_cli.main, "port", ("--device", "cpu"))):
            if not (d / f"{db}.bkn.npz").exists():
                _index(main, d, db)
            _map(main, d, db, "0,12", f"{db}_shard.O0", extra)
    finally:
        mp.undo()
    return d, d / "ref_shard.grd.npz", d / "port_shard.grd.npz"


def test_map_O12_shards_equal(shards):
    d, ref, port = shards
    with np.load(ref, allow_pickle=False) as r, \
            np.load(port, allow_pickle=False) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    assert (d / "port_shard.O0").read_bytes() == \
        (d / "ref_shard.O0").read_bytes()


SORT_CASES = {
    "O0": ["-O", "0"],
    "O15": ["-O", "15"],
    "F1": ["-F", "1"],
    "F2": ["-F", "2"],
    "F3": ["-F", "3"],
    "Sb": ["-S", "b"],
    "Sc": ["-S", "c"],
    "Sr": ["-S", "r"],
    "cover_ident": ["-C", "0.97", "-I", "0.99"],
    "score_bounds": ["-F", "1", "-H", "300", "-m", "1", "-u", "2", "-n",
                     "2"],
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sortgrcd_text_identical(shards, case):
    """Each CLI over its own shard and over both (the cross-run merge)."""
    d, ref, port = shards
    for which, ins in (("own", None), ("both", [str(ref), str(port)])):
        texts = []
        for tag, main, own in (("ref", ref_cli.main, ref),
                               ("port", port_cli.main, port)):
            out = d / f"sort_{case}_{which}.{tag}"
            assert main(["sortgrcd", *(ins or [str(own)]),
                         *SORT_CASES[case], "-o", str(out)]) == 0
            texts.append(out.read_bytes())
        assert texts[0] == texts[1], which
    if case in ("O0", "O15"):
        assert texts[0].count(b"\n") >= 3
