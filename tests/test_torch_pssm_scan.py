"""The splice-signal PSSM scan (``score/pssm.py`` ``scan_pssm``) as one
compiled pass of the native library against the numpy form it replaced
(``scan_pssm_plain``) and spaln_tpu's ``scan_pssm``: the float32 scores
must be identical bit for bit (tolerance 0: the signals are truncated to
int32, where one ulp can move a score), on every PSSM the Tetrapod
tables load (orders 0, 1 and 2), tron and nucleotide reduction, with and
without the tonic, on windows with ambiguous bases at the start, middle
and end, shorter than the matrix and empty.  The signal builders give
the same arrays with and without the library, the counters say which
path ran, and a second tron build reads no table file."""
import builtins
import dataclasses
import os

import numpy as np
import pytest

from spaln_tpu.score.pssm import scan_pssm as ref_scan_pssm

from spaln_tpu_torch import native
from spaln_tpu_torch.config import Config, CvsG, PvsG, apply_y_args, resolve
from spaln_tpu_torch.constants import NT_REDUCE4, TRON_REDUCE4
from spaln_tpu_torch.score.codepot import build_tron_signals
from spaln_tpu_torch.score.pssm import load_pssm, scan_pssm, scan_pssm_plain
from spaln_tpu_torch.score.splice import _c_short, build_splice_signals
from spaln_tpu_torch.score.tables import TableDir, find_table_dir
from spaln_tpu_torch.seq.codec import encode_dna
from spaln_tpu_torch.utils.metrics import metrics

PSSMS = ["Splice5", "Splice3", "TransInit", "TransTerm", "Branch"]
WINDOWS = ["clean", "amb_start", "amb_mid", "amb_end", "short", "empty"]


@pytest.fixture(scope="module")
def tables():
    return TableDir(find_table_dir(), species="Tetrapod")


@pytest.fixture(scope="module")
def pssms(tables):
    return {name: load_pssm(tables.path(name)) for name in PSSMS}


@pytest.fixture
def lib():
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")


def _genome(n, seed, amb=()):
    rng = np.random.default_rng(seed)
    g = rng.choice(list("ACGT"), n)
    for pos in amb:
        g[pos] = "N"
    return encode_dna("".join(g))


def _window(kind, seed):
    n = 1500
    return {"clean": lambda: _genome(n, seed),
            "amb_start": lambda: _genome(n, seed, (0,)),
            "amb_mid": lambda: _genome(n, seed, (n // 2, n // 2 + 7)),
            "amb_end": lambda: _genome(n, seed, (n - 1,)),
            "short": lambda: _genome(5, seed, (2,)),
            "empty": lambda: _genome(0, seed)}[kind]()


def _native(pssm, codes, tron, zero_tonic):
    return native.pssm_scan_native(
        pssm.mtx, pssm.nalpha, pssm.morder, pssm.offset, pssm.min_elem,
        0. if zero_tonic else pssm.tonic, codes,
        TRON_REDUCE4 if tron else NT_REDUCE4)


def _scores(fn, *args):
    """fn's scores, or the type of the error it raised."""
    try:
        return fn(*args)
    except IndexError as e:
        return type(e)


def _assert_same(got, want):
    if not isinstance(want, np.ndarray):
        assert got is want
        return
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert np.array_equal(got, want)
    # the signals' truncation at the builders' largest factor
    for f in (10.0, 24.0, 80.0):
        assert np.array_equal(_c_short(f * got), _c_short(f * want))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("zero_tonic", [False, True])
@pytest.mark.parametrize("tron", [False, True])
@pytest.mark.parametrize("name", PSSMS)
def test_native_equals_plain_and_reference(lib, pssms, name, tron,
                                           zero_tonic, window):
    pssm = pssms[name]
    codes = _window(window, 2101 + PSSMS.index(name))
    want = _scores(scan_pssm_plain, pssm, codes, tron, zero_tonic)
    _assert_same(_scores(ref_scan_pssm, pssm, codes, tron, zero_tonic),
                 want)
    _assert_same(_scores(_native, pssm, codes, tron, zero_tonic), want)
    _assert_same(_scores(scan_pssm, pssm, codes, tron, zero_tonic), want)
    if name == "Branch" and window.startswith("amb"):
        # order 0 gathers the ambiguous base's row past the 4 the
        # matrix has: both forms raise
        assert want is IndexError


@pytest.mark.parametrize("shift", ["low", "zero", "pad_edge", "wrap_edge"])
@pytest.mark.parametrize("name", ["Splice3", "TransInit", "Branch"])
def test_native_equals_plain_at_offset_edges(lib, pssms, name, shift):
    """Windows that start or end past the numpy form's padding of cols +
    2 bases: off either end reads as a bad base on both paths, up to
    2 cols + 4, where numpy's wrapped index leaves the padding."""
    pssm = pssms[name]
    order = min(pssm.morder, 2)
    offset = {"low": order - 3, "zero": 0, "pad_edge": pssm.cols + 2,
              "wrap_edge": 2 * pssm.cols + 4}[shift]
    pssm = dataclasses.replace(pssm, offset=offset)
    for n in (1, pssm.cols, 300):
        codes = _genome(n, 2201 + n)
        _assert_same(_native(pssm, codes, False, False),
                     scan_pssm_plain(pssm, codes))
    if shift == "low":
        below = dataclasses.replace(pssm, offset=order - 4)
        for fn in (_native, scan_pssm_plain):
            with pytest.raises(IndexError):
                fn(below, _genome(50, 2301), False, False)


def _cfgs(tables):
    base = apply_y_args(Config(), tables.alnparam_args())
    cdna, prot = resolve(base, CvsG), resolve(base, PvsG)
    # the branch-point bonus, off in the Tetrapod parameters, scans Branch
    branch = dataclasses.replace(
        prot, aln2=dataclasses.replace(prot.aln2, bp_factor=1.0))
    return cdna, prot, branch


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif dataclasses.is_dataclass(x):
            _assert_fields_equal(x, y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("case", ["splice_clean", "splice_amb",
                                  "splice_tron", "tron", "tron_branch"])
def test_builders_equal_without_the_library(lib, tables, monkeypatch,
                                            case):
    cdna, prot, branch = _cfgs(tables)
    amb = () if case.startswith("tron") else (0, 777, 2999)
    codes = _genome(3000, 2401, amb)
    if case.startswith("splice"):
        build = lambda: build_splice_signals(            # noqa: E731
            codes, cdna, tables, tron=case == "splice_tron")
    else:
        build = lambda: build_tron_signals(              # noqa: E731
            codes, branch if case == "tron_branch" else prot, tables)
    compiled = build()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    _assert_fields_equal(compiled, build())


@pytest.mark.parametrize("loaded", [True, False])
def test_counters_follow_the_dispatch(lib, pssms, monkeypatch, loaded):
    if not loaded:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    before = {k: metrics.counters[k]
              for k in ("pssm_scan_native", "pssm_scan_plain")}
    codes = _genome(400, 2501)
    for name in ("Splice5", "Splice3", "TransInit"):
        scan_pssm(pssms[name], codes)
    grew = {k: metrics.counters[k] - v for k, v in before.items()}
    assert grew == ({"pssm_scan_native": 3, "pssm_scan_plain": 0} if loaded
                    else {"pssm_scan_native": 0, "pssm_scan_plain": 3})


def test_second_tron_build_reads_no_table(tables, monkeypatch):
    _, _, branch = _cfgs(tables)
    codes = _genome(2000, 2601)
    build_tron_signals(codes, branch, tables)
    root = os.path.realpath(tables.root)
    opened = []
    real_open = builtins.open

    def spy(file, *args, **kwargs):
        if isinstance(file, (str, os.PathLike)) and \
                os.path.realpath(file).startswith(root):
            opened.append(os.fspath(file))
        return real_open(file, *args, **kwargs)
    monkeypatch.setattr(builtins, "open", spy)
    build_tron_signals(codes, branch, tables)
    assert opened == []
