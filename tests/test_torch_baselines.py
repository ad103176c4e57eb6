"""The port's baselines (``repro_torch.baselines``) against
``repro.baselines``.

(a) the five geometric ranks, bit for bit, on random alive masks of a
    series with ties and collinear runs, an all-dead interior and an
    all-alive mask; the round's top-k order (``lax.top_k``'s: IEEE total
    order, ties lower index first) on a signed-zero vector and on a
    ``tp_rank_s`` round full of -1s;
(b) ``compress_baseline`` for every rank, bit for bit in every result
    field: ``tests/test_baselines.py``'s ``_series(1024, 1)`` at L = 24,
    eps = 0.02; an aus_elec stand-in of 6,912 points at kappa = 48, L = 7;
    and at ``target_cr=8`` (Fig. 8's form); ``stat="pacf"`` against the
    default compilation, to a stated tolerance;
(c) PMC, Swing and Sim-Piece: reconstruction and storage bit for bit at
    several ``err`` (Swing also against the default compilation: ROADMAP
    C15); FFT within a tolerance, storage equal;
(d) ``acf_deviation`` and ``acf_constrained_search`` for the four
    parameterized methods: the same parameter, storage and deviation;
(e) the lossless counters equal the reference's on its four series;
(f) ``tests/test_baselines.py``'s properties on the port.

The reference runs compiled without XLA's float rewrites
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``,
ROADMAP C1), in a subprocess started when the first test asks for it.
The kernel and the card runs are in ``tests/test_torch_segment_scan.py``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import constrain as jcon
from repro.baselines import functional as jfun
from repro.baselines import line_simpl as jls
from repro.baselines import lossless as jll
from repro.baselines import transform as jtr
from repro.core.cameo import CameoConfig as JConfig
from repro_torch import baselines as tb
from repro_torch import convert
from repro_torch.baselines import constrain as tcon
from repro_torch.baselines import functional as tfun
from repro_torch.baselines import line_simpl as tls
from repro_torch.baselines import lossless as tll
from repro_torch.baselines import transform as ttr
from repro_torch.data.synthetic import make_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
RANKS = sorted(jls.LINE_SIMPL_BASELINES)
RESULT_FIELDS = ("kept", "xr", "deviation", "n_kept", "iters", "stat_orig",
                 "stat_new")
# compress_baseline cases: (series, config)
CASES = {
    "series": (("series", 1024, 1), dict(eps=0.02, lags=24)),
    "aus48": (("aus_elec", 6912, 0), dict(eps=0.02, lags=7, kappa=48)),
    "cr8": (("series", 1024, 1), dict(eps=0.0, lags=24, target_cr=8.0)),
}
# rank inputs: alive masks of a 96-point series with ties and collinear runs
RANK_MASKS = ("random0", "random1", "random2", "dead_interior", "all_alive")
ERRS = (0.05, 0.3, 1.0)
FUNCTIONAL = ("pmc", "swing", "simpiece")
SEARCH = (("pmc", False), ("swing", False), ("simpiece", False),
          ("fft", True))
# the reference's own lossless corpus (tests/test_baselines.py)
LOSSLESS = ("random", "constant", "seasonal", "bits")
# stat="pacf" against the default compilation (the strict flags crash XLA
# on pacf_from_acf, ROADMAP C1): XLA contracts the reconstruction's
# interpolation into an FMA (C10), so xr and the statistics part in the
# last bits; kept masks and iterations are held exactly
PACF_TOL = 1e-12
# FFT: torch's FFT and numpy's round their coefficients differently (a few
# ulp of the series' scale)
FFT_TOL = 1e-12


def _series(n=1024, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (3 * np.sin(2 * np.pi * t / 24) + np.sin(2 * np.pi * t / 168)
            + 0.15 * rng.standard_normal(n))


def _data(spec):
    kind, n, seed = spec
    if kind == "series":
        return _series(n, seed)
    return make_dataset(kind, seed=seed, length=n)


def _rank_inputs(mask: str):
    """A series of 96 points on a 0.5 grid (equal values, equal scores)
    with a collinear run (zero scores) and a constant run, and an alive
    mask with both endpoints alive."""
    x = np.round(2 * _series(96, seed=2)) / 2
    x[20:30] = 0.25 * np.arange(10)          # collinear
    x[40:50] = 1.5                           # constant
    n = x.shape[0]
    if mask == "dead_interior":
        alive = np.zeros(n, bool)
    elif mask == "all_alive":
        alive = np.ones(n, bool)
    else:
        alive = np.random.default_rng(int(mask[-1])).random(n) < 0.5
    alive[0] = alive[-1] = True
    return x, alive


# the issue's signed-zero vector: lax.top_k orders by IEEE's total order
TOPK_VEC = np.array([1.0, -1.0, -1.0, 0.0, -0.0, -1.0, np.inf, -1.0])


def _tps_round_input():
    """A round-0 score vector of ``tp_rank_s`` over a series with long
    monotone runs: most points are not turning points and score -1."""
    x = np.concatenate([np.arange(40.0), 40 - np.arange(30.0),
                        10 + 0.5 * np.arange(30.0)])
    x[::7] += 0.25
    return x


def _tcfg(**kw):
    return convert.config_from_dict(dataclasses.asdict(
        JConfig(dtype="float64", **kw)))


def _jfn(name):
    return {"pmc": jfun.pmc_compress, "swing": jfun.swing_compress,
            "simpiece": jfun.simpiece_compress, "fft": jtr.fft_compress}[name]


def _tfn(name):
    return {"pmc": tfun.pmc_compress, "swing": tfun.swing_compress,
            "simpiece": tfun.simpiece_compress, "fft": ttr.fft_compress}[name]


def _lossless_series(name):
    rng = np.random.default_rng(11)
    series = {"random": rng.standard_normal(3000),
              "constant": np.full(2000, -3.5),
              "seasonal": _series(seed=12),
              "bits": rng.integers(0, 2 ** 64, 1000,
                                   dtype=np.uint64).view(np.float64)}
    return series[name]


def _reference(out_path):
    """Strict-compiled JAX: ranks, top-k orders, compress_baseline, the
    functional baselines, the searches."""
    jax.config.update("jax_enable_x64", True)
    out = {}
    for mask in RANK_MASKS:
        x, alive = _rank_inputs(mask)
        for name in RANKS:
            out[f"rank/{mask}/{name}"] = np.asarray(jax.jit(
                jls.LINE_SIMPL_BASELINES[name])(jnp.asarray(x),
                                                jnp.asarray(alive)))
    out["topk/signed_zero"] = np.asarray(jax.lax.top_k(
        -jnp.asarray(TOPK_VEC), TOPK_VEC.shape[0])[1])
    x = _tps_round_input()
    n = x.shape[0]
    idx = np.arange(n)
    score = jls.tp_rank_s(jnp.asarray(x), jnp.ones(n, bool))
    score = jnp.where((idx > 0) & (idx < n - 1), score, jnp.inf)
    out["topk/tps_score"] = np.asarray(score)
    out["topk/tps_order"] = np.asarray(jax.lax.top_k(-score, n)[1])
    for case, (spec, kw) in CASES.items():
        for name in RANKS:
            r = jls.compress_baseline(jnp.asarray(_data(spec)),
                                      JConfig(dtype="float64", **kw), name)
            for f in RESULT_FIELDS:
                out[f"cb/{case}/{name}/{f}"] = np.asarray(getattr(r, f))
    x = _series(seed=3)
    for name in FUNCTIONAL:
        for err in ERRS:
            recon, stored = _jfn(name)(x, err)
            out[f"fn/{name}/{err}/recon"] = np.asarray(recon)
            out[f"fn/{name}/{err}/stored"] = np.asarray(stored)
    for err in ERRS:
        recon, stored = jfun.pmc_compress(x.astype(np.float32), err)
        out[f"fn32/pmc/{err}/recon"] = np.asarray(recon)
        out[f"fn32/pmc/{err}/stored"] = np.asarray(stored)
    cfg = JConfig(eps=0.02, lags=24, dtype="float64")
    x6 = _series(seed=6)
    for name, isint in SEARCH:
        recon, stored, dev, p = jcon.acf_constrained_search(
            x6, cfg, _jfn(name), param_is_int=isint, iters=8)
        for f, v in (("recon", recon), ("stored", stored), ("dev", dev),
                     ("param", p)):
            out[f"search/{name}/{f}"] = np.asarray(v)
    recon, _ = jfun.pmc_compress(x6, 0.4)
    out["acf_deviation"] = np.asarray(jcon.acf_deviation(x6, recon, cfg))
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def strict(tmp_path_factory):
    """The reference's results, computed in a subprocess started when the
    first test asks for them."""
    out = tmp_path_factory.mktemp("jax_strict_baselines") / "strict.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cache = {}

    def get():
        if not cache:
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log
            with np.load(out) as z:
                cache.update({k: z[k] for k in z.files})
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_cb():
    """The port's compress_baseline runs of every case and rank, on the
    CPU."""
    return {(case, name): tls.compress_baseline(_data(spec), _tcfg(**kw),
                                                name, device="cpu")
            for case, (spec, kw) in CASES.items() for name in RANKS}


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and np.array_equal(
        np.atleast_1d(a).view(np.uint8), np.atleast_1d(b).view(np.uint8))


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# (a) ranks and the top-k order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", RANK_MASKS)
@pytest.mark.parametrize("name", RANKS)
def test_rank_matches_reference(strict, name, mask):
    x, alive = _rank_inputs(mask)
    got = tls.LINE_SIMPL_BASELINES[name](torch.from_numpy(x),
                                         torch.from_numpy(alive))
    want = strict()[f"rank/{mask}/{name}"]
    assert _bits_equal(got.numpy(), want), np.flatnonzero(got.numpy() != want)


def test_top_k_total_order_signed_zero(strict):
    """+0.0 ranks above -0.0 and equal values go lower index first, as
    ``lax.top_k`` orders them ([1 2 5 7 4 3 0 6]); a stable sort by IEEE
    comparison would put index 3 before index 4."""
    v = torch.from_numpy(-TOPK_VEC)
    vals, order = tls.top_k_total(v, v.shape[0])
    want = strict()["topk/signed_zero"]
    assert order.tolist() == want.tolist() == [1, 2, 5, 7, 4, 3, 0, 6]
    assert _bits_equal(vals.numpy(), (-TOPK_VEC)[want])


def test_top_k_tie_order_on_tps_round(strict):
    """A tp_rank_s round whose non-turning points all score -1: the picks
    are decided by the tie order alone, lower index first."""
    ref = strict()
    x = _tps_round_input()
    n = x.shape[0]
    idx = torch.arange(n)
    score = tls.tp_rank_s(torch.from_numpy(x), torch.ones(n, dtype=torch.bool))
    score = torch.where((idx > 0) & (idx < n - 1), score, float("inf"))
    assert _bits_equal(score.numpy(), ref["topk/tps_score"])
    assert int((score == -1).sum()) > n // 2
    _, order = tls.top_k_total(-score, n)
    assert order.tolist() == ref["topk/tps_order"].tolist()
    for k in (1, 5, 17):
        assert tls.top_k_total(-score, k)[1].tolist() == \
            ref["topk/tps_order"][:k].tolist()


# ---------------------------------------------------------------------------
# (b) compress_baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", RANKS)
def test_compress_baseline_matches_reference(strict, port_cb, case, name):
    res = port_cb[(case, name)]
    ref = strict()
    for f in RESULT_FIELDS:
        got = _np(getattr(res, f))
        want = ref[f"cb/{case}/{name}/{f}"]
        if f in ("n_kept", "iters"):
            assert int(got) == int(want), (f, got, want)
        else:
            assert _bits_equal(got, want.astype(got.dtype)), f
    if "target_cr" not in CASES[case][1]:
        assert float(res.deviation) <= CASES[case][1]["eps"]


@pytest.mark.parametrize("name", RANKS)
def test_compress_baseline_pacf_default_jit(name):
    """stat="pacf" against the reference's default compilation: kept mask
    and iterations exactly, xr, deviation and statistics within
    PACF_TOL."""
    jax.config.update("jax_enable_x64", True)
    x = _series(512, seed=2)
    kw = dict(eps=0.02, lags=12, stat="pacf")
    ref = jls.compress_baseline(jnp.asarray(x), JConfig(dtype="float64", **kw),
                                name)
    res = tls.compress_baseline(x, _tcfg(**kw), name, device="cpu")
    assert np.array_equal(res.kept.numpy(), np.asarray(ref.kept))
    assert int(res.iters) == int(ref.iters)
    assert int(res.n_kept) == int(ref.n_kept)
    for f in ("xr", "deviation", "stat_orig", "stat_new"):
        np.testing.assert_allclose(_np(getattr(res, f)),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=PACF_TOL, err_msg=f)


def test_compress_baseline_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown line-simplification"):
        tls.compress_baseline(_series(64), _tcfg(), "nope", device="cpu")


# ---------------------------------------------------------------------------
# (c) the functional baselines and FFT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("err", ERRS)
@pytest.mark.parametrize("name", FUNCTIONAL)
def test_functional_matches_reference(strict, name, err):
    recon, stored = _tfn(name)(_series(seed=3), err, device="cpu")
    ref = strict()
    assert stored == int(ref[f"fn/{name}/{err}/stored"])
    assert recon.dtype == torch.float64 and recon.device.type == "cpu"
    assert _bits_equal(recon.numpy(), ref[f"fn/{name}/{err}/recon"])


@pytest.mark.parametrize("err", ERRS)
def test_pmc_float32_matches_reference(strict, err):
    """PMC keeps a float32 series' type, as the reference's ``jnp.asarray``
    does: the scan and the midranges in float32."""
    x32 = _series(seed=3).astype(np.float32)
    recon, stored = tfun.pmc_compress(x32, err, device="cpu")
    ref = strict()
    assert stored == int(ref[f"fn32/pmc/{err}/stored"])
    assert recon.dtype == torch.float32
    assert _bits_equal(recon.numpy(), ref[f"fn32/pmc/{err}/recon"])


@pytest.mark.parametrize("err", ERRS)
def test_swing_default_jit_anchor_fma(err):
    """ROADMAP C15: XLA's default compilation contracts Swing's anchor
    ``x0 + 0.5 (u + l) (t - 1 - t0)`` (and its cone arithmetic) into fused
    multiply-adds, so the default-compiled scan parts from the op-by-op one
    in the last bits of x0; the breaks, the storage and the reconstruction
    to 1e-12 stay."""
    jax.config.update("jax_enable_x64", True)
    x = _series(seed=3)
    want, stored = jfun.swing_compress(x, err)
    got, s = tfun.swing_compress(x, err, device="cpu")
    assert s == stored
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("m", (1, 4, 64, 513, 2000))
def test_fft_matches_reference(m):
    """FFT within FFT_TOL of numpy's, with equal storage."""
    x = _series(seed=5)
    want, stored = jtr.fft_compress(x, m)
    got, s = ttr.fft_compress(x, m, device="cpu")
    assert s == stored
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FFT_TOL)


# ---------------------------------------------------------------------------
# (d) the ACF-constrained search
# ---------------------------------------------------------------------------

def test_acf_deviation_matches_reference(strict):
    cfg = _tcfg(eps=0.02, lags=24)
    x6 = _series(seed=6)
    recon, _ = tfun.pmc_compress(x6, 0.4, device="cpu")
    got = tcon.acf_deviation(x6, recon, cfg, device="cpu")
    assert _bits_equal(np.float64(got), strict()["acf_deviation"])


@pytest.mark.parametrize("name,isint", SEARCH)
def test_acf_constrained_search_matches_reference(strict, name, isint):
    cfg = _tcfg(eps=0.02, lags=24)
    recon, stored, dev, p = tcon.acf_constrained_search(
        _series(seed=6), cfg, _tfn(name), param_is_int=isint, iters=8,
        device="cpu")
    ref = strict()
    assert p == float(ref[f"search/{name}/param"])
    assert stored == int(ref[f"search/{name}/stored"])
    if isint:
        # the FFT's deviations part in the last bits (FFT_TOL)
        assert abs(dev - float(ref[f"search/{name}/dev"])) <= 1e-12
    else:
        assert _bits_equal(np.float64(dev), ref[f"search/{name}/dev"])
        assert _bits_equal(recon.numpy(), ref[f"search/{name}/recon"])
    assert dev <= cfg.eps


# ---------------------------------------------------------------------------
# (e) lossless counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("series", LOSSLESS)
def test_lossless_matches_reference(series):
    x = _lossless_series(series)
    for t_fn, j_fn in ((tll.gorilla_bits_per_value,
                        jll.gorilla_bits_per_value),
                       (tll.chimp_bits_per_value, jll.chimp_bits_per_value),
                       (tll.gorilla_bits_per_value_loop,
                        jll.gorilla_bits_per_value_loop),
                       (tll.chimp_bits_per_value_loop,
                        jll.chimp_bits_per_value_loop)):
        assert t_fn(x) == j_fn(x), t_fn.__name__


def test_package_exports_reference_names():
    import repro.baselines as jb
    names = [n for n in vars(jb) if not n.startswith("_")
             and n not in ("line_simpl", "functional", "transform",
                           "constrain", "lossless")]
    assert names and all(hasattr(tb, n) for n in names), names


# ---------------------------------------------------------------------------
# (f) tests/test_baselines.py's properties, on the port
# ---------------------------------------------------------------------------

CFG = dict(eps=0.02, lags=24)
PROPERTIES = ([f"line_simpl_{n}" for n in RANKS]
              + ["pmc_error_bound", "swing_reconstruction", "simpiece_bound",
                 "fft_more_coeffs", "lossless_bits", "lossless_loops"]
              + [f"search_{n}" for n, _ in SEARCH])


@pytest.mark.parametrize("prop", PROPERTIES)
def test_reference_properties_on_port(prop):
    cfg = _tcfg(**CFG)
    cpu = dict(device="cpu")
    if prop.startswith("line_simpl_"):
        x = _series()
        res = tb.line_simpl.compress_baseline(x, cfg, prop[11:], **cpu)
        assert float(res.deviation) <= cfg.eps + 1e-12
        assert int(res.n_kept) < x.shape[0]
    elif prop == "pmc_error_bound":
        x = _series()
        recon, stored = tb.pmc_compress(x, 0.5, **cpu)
        assert float(np.max(np.abs(recon.numpy() - x))) <= 0.5 + 1e-9
        assert stored < 2 * len(x)
    elif prop == "swing_reconstruction":
        x = _series(seed=3)
        recon, stored = tb.swing_compress(x, 0.4, **cpu)
        assert float(np.max(np.abs(recon.numpy() - x))) <= 1.0
        assert stored < 2 * len(x)
    elif prop == "simpiece_bound":
        x = _series(seed=4)
        recon, stored = tb.simpiece_compress(x, 0.5, **cpu)
        assert float(np.max(np.abs(recon.numpy() - x))) <= 0.5 + 0.5 + 1e-9
        assert stored > 0
    elif prop == "fft_more_coeffs":
        x = _series(seed=5)
        r1, _ = tb.fft_compress(x, 4, **cpu)
        r2, _ = tb.fft_compress(x, 64, **cpu)
        assert float(np.mean((r2.numpy() - x) ** 2)) <= \
            float(np.mean((r1.numpy() - x) ** 2)) + 1e-12
    elif prop == "lossless_bits":
        x = _series(seed=7)
        assert 1.0 <= tb.gorilla_bits_per_value(x) <= 80.0
        assert 1.0 <= tb.chimp_bits_per_value(x) <= 80.0
        assert tb.gorilla_bits_per_value(np.ones(1000)) < 2.0
        assert tb.chimp_bits_per_value(np.ones(1000)) < 3.0
    elif prop == "lossless_loops":
        for name in LOSSLESS:
            x = _lossless_series(name)
            assert tll.gorilla_bits_per_value(x) == \
                tll.gorilla_bits_per_value_loop(x)
            assert tll.chimp_bits_per_value(x) == \
                tll.chimp_bits_per_value_loop(x)
    else:
        name = prop[7:]
        recon, stored, dev, p = tb.acf_constrained_search(
            _series(seed=6), cfg, _tfn(name), param_is_int=name == "fft",
            iters=8, **cpu)
        assert dev <= cfg.eps + 1e-9
        assert stored > 0


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
