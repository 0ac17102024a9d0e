"""The port's ILD tools against spaln_tpu: fit_ild (torch.autograd and
torch.optim.Adam here, optax Adam there: the same model in float32) to a
tolerance, and `ild compare/decompose/plot` from a saved .ild.json
byte-identical.

The tolerance of a fit: NLL relative 1e-5, weights absolute 0.005, theta
and kappa relative 1%, mu within 1% of its component's theta.  The two
optimizers round differently; over the mixture below the NLLs agree to
7 digits, but the location of a wide component is barely determined by
the likelihood (seed 2: mu 32.06 against 29.96 at theta 572, seed 0:
0.33 against 0.00 at theta 630), so mu is held on the scale of its
component, where a shift of it moves the density.
"""
import json

import numpy as np
import pytest
import torch

from spaln_tpu import cli as ref_cli
from spaln_tpu.tools import fitild as R
from spaln_tpu_torch import cli as port_cli
from spaln_tpu_torch.tools import fitild as P

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is small tensors a step: one intra-op
    thread runs it faster than many, and keeps the file's time under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MIXTURE = dict(weights=[0.7, 0.3], mus=[30., 30.], thetas=[60., 600.],
               kappas=[1.2, 1.8])


def assert_fit_close(got, want):
    assert got.n == want.n
    assert len(got.weights) == len(want.weights)
    assert abs(got.nll - want.nll) <= 1e-5 * abs(want.nll)
    for g, w, th in zip(got.weights, want.weights, want.thetas):
        assert abs(g - w) <= 0.005
    for key in ("thetas", "kappas"):
        for g, w in zip(getattr(got, key), getattr(want, key)):
            assert abs(g - w) <= 0.01 * abs(w), (key, g, w)
    for g, w, th in zip(got.mus, want.mus, want.thetas):
        assert abs(g - w) <= 0.01 * th, ("mus", g, w, th)


def _sample(seed, n=4000, **mix):
    return R.sample_frechet_mixture(np.random.default_rng(seed), n,
                                    **(mix or MIXTURE))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_ild_matches_reference(seed):
    lens = _sample(seed)
    want = R.fit_ild(lens, n_modes=2, steps=1500)
    got = P.fit_ild(lens, n_modes=2, steps=1500, device="cpu")
    assert_fit_close(got, want)
    assert 30 < got.thetas[0] < 120 and 350 < got.thetas[1] < 1100
    assert got.mus[0] + got.thetas[0] <= got.mus[1] + got.thetas[1]


def test_fit_ild_keeps_the_best_step():
    """A step size that overshoots: the fit returns the best step's
    parameters and NLL (strict <, finite values), not the last."""
    lens = _sample(3, n=1500)
    got = P.fit_ild(lens, n_modes=2, steps=200, lr=0.5, device="cpu")
    last = P.fit_ild(lens, n_modes=2, steps=199, lr=0.5, device="cpu")
    assert np.isfinite(got.nll) and got.nll <= last.nll
    fit = P.IldFit(**{k: getattr(got, k) for k in
                      ("weights", "mus", "thetas", "kappas", "nll", "n")})
    x = np.asarray(lens, np.float64)
    nll = -np.mean(np.log(P.ild_pdf(fit, x)))
    assert abs(nll - got.nll) <= 1e-4 * abs(got.nll)


def test_fit_ild_cuda_without_gpu_is_an_error(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.fit_ild(_sample(0, n=100))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two length lists and the spaln_tpu fit of the first, saved."""
    d = tmp_path_factory.mktemp("ild")
    for name, seed, mix in (
            ("a", 3, dict(weights=[1.0], mus=[30.], thetas=[120.],
                          kappas=[1.1])),
            ("b", 4, dict(weights=[0.6, 0.4], mus=[20., 20.],
                          thetas=[80., 600.], kappas=[1.2, 1.5]))):
        lens = _sample(seed, n=800, **mix)
        (d / f"{name}.txt").write_text(
            "\n".join(str(int(x)) for x in lens) + "\n")
    assert ref_cli.main(["ild", "fit", str(d / "a.txt"), "-m", "1", "-o",
                         str(d / "a.fit")]) == 0
    (d / "a.ild.json").write_text(
        (d / "a.fit").read_text().splitlines()[0] + "\n")
    (d / "b.ild.json").write_text(json.dumps(dict(
        weights=[0.6, 0.4], mus=[20., 20.], thetas=[80., 600.],
        kappas=[1.2, 1.5], nll=0., n=800)) + "\n")
    return d


def test_ild_fit_cli(files):
    """`ild fit` (on the CPU here, the card by default) writes the fit's
    JSON and -yI line; both within the fit tolerance of spaln_tpu's."""
    d = files
    assert port_cli.main(["ild", "fit", str(d / "a.txt"), "-m", "1", "-o",
                          str(d / "a.port.fit"), "--device", "cpu"]) == 0
    got = (d / "a.port.fit").read_text().splitlines()
    want = (d / "a.fit").read_text().splitlines()
    assert len(got) == len(want) == 2
    assert_fit_close(P.IldFit(**json.loads(got[0])),
                     R.IldFit(**json.loads(want[0])))
    assert got[1].startswith("-yI") and want[1].startswith("-yI")
    a, k, m, t = (float(x) for x in got[1][3:].split())
    a_r, k_r, m_r, t_r = (float(x) for x in want[1][3:].split())
    assert a == a_r == 1.0
    assert abs(k - k_r) <= 0.01 * k_r and abs(t - t_r) <= 0.01 * t_r
    assert abs(m - m_r) <= 0.01 * t_r + 0.01


def test_ild_fit_cli_cuda_without_gpu_is_an_error(files, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_cli.main(["ild", "fit", str(files / "a.txt")])


ILD_CASES = {
    "compare": ["compare", "{d}/a.ild.json", "{d}/b.ild.json",
                "{d}/a.ild.json"],
    "decompose": ["decompose", "{d}/b.ild.json"],
    "decompose_xmax": ["decompose", "{d}/a.ild.json", "--x-max", "5000"],
    "plot": ["plot", "{d}/a.ild.json"],
    "plot_sample": ["plot", "{d}/b.ild.json", "{d}/b.txt"],
}


@pytest.mark.parametrize("case", sorted(ILD_CASES))
def test_ild_saved_fit_text_identical(files, case):
    argv = [a.format(d=files) for a in ILD_CASES[case]]
    texts = []
    for tag, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        out = files / f"{case}.{tag}"
        assert main(["ild", *argv, "-o", str(out)]) == 0
        texts.append(out.read_bytes())
    assert texts[0] == texts[1]
    assert texts[0].count(b"\n") >= 2


def test_ild_helpers_equal():
    f = R.IldFit([0.6, 0.4], [20., 20.], [80., 600.], [1.2, 1.5], 0., 100)
    g = P.IldFit(*vars(f).values())
    x = np.geomspace(25, 20000, 50)
    np.testing.assert_array_equal(P.ild_pdf(g, x), R.ild_pdf(f, x))
    np.testing.assert_array_equal(P.decompose_ild(g, x),
                                  R.decompose_ild(f, x))
    h = R.IldFit([1.0], [20.], [100.], [1.3], 0., 100)
    assert P.compare_ilds(g, P.IldFit(*vars(h).values())) == \
        R.compare_ilds(f, h)
    assert g.yI_line() == f.yI_line()
    for seed in (5, 6):
        np.testing.assert_array_equal(
            P.sample_frechet_mixture(np.random.default_rng(seed), 300,
                                     **MIXTURE),
            R.sample_frechet_mixture(np.random.default_rng(seed), 300,
                                     **MIXTURE))
