"""The step probes' plain versions against the TPU scripts themselves.

Every body of scripts/pallas_probe.py, pallas_probe2.py, probe_gather.py,
probe_step_ops.py and probe_int16.py runs in Pallas's TPU interpret mode
on the CPU (``force_tpu_interpret_mode``) at a few steps, on the inputs
the script's own main draws from a fixed seed, and the counterpart in
spaln_tpu_torch.probes must give the same carry: tolerance 0 (integer
bodies; the float log tail is truncated to an integer).  The bodies are
taken from the scripts, not copied: their mains run with the timing
helpers patched to hand each body (or its inputs) over.  dg6 of
probe_gather is held against the script's numpy reference ref_result:
its Pallas body slices 12 row blocks of dg6's 6-block table and does not
run.  Also the kernel builds' tag (no nvcc needed).
"""
import contextlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spaln_tpu_torch.ops import dp_spliced_cuda as K
from spaln_tpu_torch.probes import (ablate_pallas, pallas_probe,
                                    pallas_probe2, probe_gather,
                                    probe_int16, probe_step_ops)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
CPU = torch.device("cpu")


def _script(name: str, argv: list):
    """A fresh import of scripts/<name>.py with ``argv`` as sys.argv (two
    of them read it at import)."""
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [path] + argv)
        spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    """Ends a script's main once its inputs are captured."""


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------- pallas_probe
T1 = 16


@pytest.fixture(scope="module")
def pallas_probe_runs():
    """Each body's (inputs, JAX result) from the script's main at T1 steps,
    and k0's result."""
    P = _script("pallas_probe", [])
    P.T = T1
    calls, k0 = [], []
    np.random.seed(SEED)
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(P, "timed", lambda fn, *a: calls.append((fn, a)) or 0.0)
        mp.setattr(np.testing, "assert_array_equal",
                   lambda y, want: k0.append((y, want)))
        P.main()
        runs = {b: ([np.asarray(a) for a in args], np.asarray(fn(*args)))
                for b, (fn, args) in zip(pallas_probe.BODIES, calls)}
    assert len(calls) == len(pallas_probe.BODIES)
    return runs, k0


def test_pallas_probe_inputs_are_the_scripts(pallas_probe_runs):
    runs, k0 = pallas_probe_runs
    a = pallas_probe.inputs(SEED)
    assert np.array_equal(runs["base"][0][0], a["x"])
    assert np.array_equal(runs["take1k_along"][0][1], a["tab1k"])
    assert np.array_equal(runs["base"][0][1], a["tab128"])


def test_pallas_probe_k0(pallas_probe_runs):
    (y, _), = pallas_probe_runs[1]
    x = _t(pallas_probe.inputs(SEED)["x"])
    assert np.array_equal(pallas_probe.k0(x).numpy(), y)


@pytest.mark.parametrize("body", pallas_probe.BODIES)
def test_pallas_probe_body(pallas_probe_runs, body):
    (x, tab), want = pallas_probe_runs[0][body]
    got = pallas_probe.run(body, _t(x), _t(tab), T1)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


# --------------------------------------------------------- pallas_probe2
T2 = 16


@pytest.fixture(scope="module")
def pallas_probe2_runs():
    """Each body of the script's main (its ``marginal`` patched to hand
    it over) run by the script's make_run at T2 steps."""
    P = _script("pallas_probe2", [str(T2)])
    bodies = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "marginal", lambda body: bodies.append(body) or (0, 0))
        P.main()
    assert len(bodies) == len(pallas_probe2.BODIES)
    np.random.seed(SEED)      # marginal's draws, in its order
    stk = np.random.randint(-100, 100, (P.NBT, P.SOP * P.GRP, 128), np.int32)
    bstr = np.random.randint(-100, 100, (P.GRP, 128), np.int32)
    x = np.random.randint(0, 100, (P.GRP, 128), np.int32)
    with pltpu.force_tpu_interpret_mode():
        runs = {name: np.asarray(P.make_run(body, T2)(stk, bstr, x))
                for name, body in zip(pallas_probe2.BODIES, bodies)}
    return (stk, bstr, x), runs


def test_pallas_probe2_inputs_are_the_scripts(pallas_probe2_runs):
    (stk, bstr, x), _ = pallas_probe2_runs
    a = pallas_probe2.inputs(SEED)
    for k, v in (("stk", stk), ("bstr", bstr), ("x", x)):
        assert np.array_equal(a[k], v), k


@pytest.mark.parametrize("body", pallas_probe2.BODIES)
def test_pallas_probe2_body(pallas_probe2_runs, body):
    (stk, bstr, x), runs = pallas_probe2_runs
    got = pallas_probe2.run(body, _t(x), _t(stk), _t(bstr), T2)
    assert np.array_equal(got.numpy(), runs[body])


# ---------------------------------------------------------- probe_gather
TG = 24


@pytest.fixture(scope="module")
def gather_script():
    """The script and the (key, table, carry) its main builds."""
    G = _script("probe_gather", [])
    seen = {}

    def ref(variant, key, tbl, steps, x):
        seen.update(key=list(key), tbl=np.asarray(tbl), x=np.asarray(x))
        raise _Stop("inputs captured")

    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(sys, "argv", ["probe_gather.py", "base", "8"])
        mp.setattr(G, "ref_result", ref)
        with pytest.raises(_Stop):
            G.main()
    return G, seen


def test_compiled_chain_key_is_the_scripts(gather_script):
    """chain120's runs are compiled into csrc/probes.cu as the script
    compiles its key into its kernel: the same 120 (start, value), which
    the plain version's KEY holds too."""
    _, seen = gather_script
    src = (K.CSRC / "probes.cu").read_text()

    def table(name):
        body = src[src.index(f"constexpr int {name}[NKEY] = {{"):]
        body = body[body.index("{") + 1:body.index("};")]
        return [int(x) for x in body.replace(",", " ").split()]
    assert list(zip(table("start"), table("value"))) == seen["key"]
    assert list(probe_gather.KEY) == seen["key"]


def test_probe_gather_inputs_are_the_scripts(gather_script):
    _, seen = gather_script
    a = probe_gather.inputs()
    assert a["key"] == seen["key"] and len(a["key"]) == 120
    assert np.array_equal(a["tbl"], seen["tbl"])
    assert np.array_equal(a["x"], seen["x"])


@pytest.mark.parametrize("variant", ["base", "chain120", "dg12"])
def test_probe_gather_variant(gather_script, variant):
    G, _ = gather_script
    a = probe_gather.inputs()
    with pltpu.force_tpu_interpret_mode():
        call, tbl_in = G.make_kernel(variant, tuple(a["key"]), a["tbl"], TG)
        want = np.asarray(call(a["x"], tbl_in))
    got = probe_gather.run(variant, _t(a["x"]), _t(a["tbl"]),
                           _t(a["packed"]), TG)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", probe_gather.BODIES)
def test_probe_gather_against_ref_result(gather_script, variant):
    """Every variant (dg6 only so: its Pallas body does not run) against
    the script's numpy reference, and the port's copy of it."""
    G, _ = gather_script
    a = probe_gather.inputs()
    want = G.ref_result(variant, a["key"], a["tbl"], TG, a["x"])
    assert np.array_equal(
        probe_gather.ref_result(variant, a["key"], a["tbl"], TG, a["x"]),
        want)
    got = probe_gather.run(variant, _t(a["x"]), _t(a["tbl"]),
                           _t(a["packed"]), TG)
    assert np.array_equal(got.numpy(), want)


# -------------------------------------------- probe_step_ops, probe_int16
TS = 32
TI = 24


def _build_inputs(name: str) -> list:
    """The arrays the script's main hands each built kernel, in order
    (its ``build`` patched to record them; jit patched away)."""
    S = _script(name, [])
    got = []

    def build(*_):
        def call(*arrays):
            got.append([np.asarray(a) for a in arrays])
            raise _Stop("inputs captured")
        return call

    real = S.jax

    class _Jax:                       # the script's jax, with jit a no-op
        jit = staticmethod(lambda f: f)

        def __getattr__(self, k):
            return getattr(real, k)

    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(open(os.devnull, "w")):
        mp.setattr(sys, "argv", [name, "8"])
        mp.setattr(S, "build", build)
        mp.setattr(S, "jax", _Jax())
        S.main()
    return S, got


@pytest.fixture(scope="module")
def step_ops_script():
    return _build_inputs("probe_step_ops")


def test_probe_step_ops_inputs_are_the_scripts(step_ops_script):
    _, got = step_ops_script
    a = probe_step_ops.inputs()
    assert len(got) == len(probe_step_ops.BODIES)
    for arrays in got:
        for k, v in zip(("x", "big", "big2"), arrays):
            assert np.array_equal(a[k], v), k


@pytest.mark.parametrize("variant", probe_step_ops.BODIES)
def test_probe_step_ops_variant(step_ops_script, variant):
    S, _ = step_ops_script
    a = probe_step_ops.inputs()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(S.build(variant, TS)(a["x"], a["big"], a["big2"]))
    got = probe_step_ops.run(variant, _t(a["x"]), _t(a["big"]),
                             _t(a["big2"]), TS)
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def int16_script():
    return _build_inputs("probe_int16")


def test_probe_int16_inputs_are_the_scripts(int16_script):
    _, got = int16_script
    a = probe_int16.inputs()
    assert len(got) == len(probe_int16.BODIES)
    for body, (x,) in zip(probe_int16.BODIES, got):
        assert a[body].dtype == x.dtype and np.array_equal(a[body], x)


@pytest.mark.parametrize("dtype,rows", probe_int16.CONFIGS)
def test_probe_int16_config(int16_script, dtype, rows):
    """Enough steps that the int16 tiles wrap (a step adds ~1,900)."""
    S, _ = int16_script
    x = probe_int16.inputs()[f"{dtype}_r{rows}"]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(S.build(dtype, rows, TI)(x))
    got = probe_int16.run(_t(x), TI)
    assert got.dtype == probe_int16.DTYPE[dtype]
    assert np.array_equal(got.numpy(), want)
    if dtype == "i16":            # the wrap changes the int16 dynamics
        as32 = probe_int16.plain(_t(x.astype(np.int32)), TI)
        assert not np.array_equal(as32.numpy().astype(np.int16), want)


# ----------------------------------------------------- builds, knock-outs
def test_build_tag_hashes_source_and_defines(tmp_path):
    """No defines: the tag of the source alone (the production library's
    name is unchanged); each define, and their order, changes it."""
    import hashlib
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    plain_tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    assert K.build_tag(src) == plain_tag
    tags = {K.build_tag(src, d) for d in
            [(), ("SLAB_ABLATE=0",), ("SLAB_ABLATE=1",),
             ("A", "B"), ("B", "A")]}
    assert len(tags) == 5
    assert K.build_tag(K.SOURCE) == hashlib.sha256(
        K.SOURCE.read_bytes()).hexdigest()[:16]


def test_knockouts_map_to_the_kernels_defines():
    assert ablate_pallas.defines("none") == ("SLAB_ABLATE=0",)
    assert [ablate_pallas.defines(k)[0] for k in ablate_pallas.KNOCKOUTS] \
        == [f"SLAB_ABLATE={i}" for i in range(9)]
    src = K.SOURCE.read_text()
    for i, name in enumerate(["NONE", "NOSCORE", "NOEDGE", "NOIPEN",
                              "NOCLOSE", "NOPUSH", "NOEMIT",
                              "NOCLOSE_LIVE", "NOPUSH_LIVE"]):
        assert f"ABL_{name}" in src
        assert ablate_pallas.KNOCKOUTS[i] == name.lower()


def test_probe_wrappers_take_cpu_tensors_only_as_plain():
    """A CPU tensor runs the plain version; the kernel path refuses a
    CPU device rather than fall back."""
    from spaln_tpu_torch.probes import _cuda
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cuda.launch("probe_pallas", "base", 0, x, x, 128, 4, 128, x)
    assert not _cuda.launches
