"""The port's ``compress_batch`` and ``compress_multivariate`` against the
JAX package, and the lane axis of the round body and of its four kernels.

(a) port against JAX: ``compress_batch`` on ``tests/test_backend.py``'s
    corpus (kept and iterations equal, deviations within 1e-12), one
    batched round from one converted carry (``repro_torch.convert``) held
    against one JAX batched chunk of one round, and
    ``compress_multivariate`` on ``tests/test_multivariate.py``'s corpus
    (union kept, ``xr``, iterations and ``col_n_kept`` equal, deviations
    within 1e-12), with per-column ``eps_c`` and with ``target_cr``.  The
    multivariate columns part from JAX's default compilation at float32
    ranking near-ties (ROADMAP.md C7: XLA's float32 rewrites, as in
    ``tests/test_torch_cameo.py``), so they are held to JAX compiled without
    those rewrites ("strict", in a subprocess), which the port matches;
(b) lanes against per-series runs in the port: every lane of
    ``compress_batch`` equals ``compress_rounds`` on its series (kept,
    iterations and ``xr`` equal, deviation exactly equal), across the
    configurations of the rounds mode;
(c) a batch built to exercise the round loop's lane groups: its lanes
    finish at different rounds, sit in both small/large regimes in one
    round and differ in whether they reach tier C, and the test asserts
    each;
(d) the batched plain form of each kernel of the rounds path equals its
    1-D form lane by lane, and, on a card only, each batched kernel equals
    its plain version (tolerance 0; lag_dot 1e-10 of max|plain|) and its
    one-lane launches bit for bit; prefix_sum's plain version, and a model
    of its kernel's tiles and carries, sum in XLA's cumsum order (equal to
    ``jax.numpy.cumsum`` bit for bit).
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

from repro.core import cameo as jc
from repro_torch import convert
from repro_torch.core import cameo as tc
from repro_torch.core.acf import acf_from_aggregates, extract_aggregates
from repro_torch.kernels import fused_round as t_fused
from repro_torch.kernels.acf_impact import acf_impact_cuda, acf_impact_plain
from repro_torch.kernels.lag_dot import lag_dot_cuda, lag_dot_plain
from repro_torch.kernels.prefix_sum import prefix_sum_cuda, prefix_sum_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)          # chip_smoke.py, at the repository root
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
FIELDS = ("xr", "alive", "prev", "nxt", "y", "tbl", "alpha", "dev", "rounds",
          "done", "blocked", "retried", "saw_c")
MV_CFG = dict(eps=2e-2, lags=12, mode="rounds", max_rounds=60,
              dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


def T(a):
    return torch.from_numpy(np.array(a))


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (np.sin(2 * np.pi * t / 24) + 0.5 * np.sin(2 * np.pi * t / 168)
            + 0.15 * rng.standard_normal(n))


def _corpus(n=512, B=3):
    return np.stack([_series(n, seed=s) for s in range(B)])


def _mv_series(n=2048, C=3, seed=0):
    """``tests/test_multivariate.py``'s corpus."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    base = 3 * np.sin(2 * np.pi * t / 24) + np.sin(2 * np.pi * t / 168)
    cols = [base + 0.2 * rng.standard_normal(n)]
    for c in range(1, C):
        cols.append(0.5 / c * base + c
                    + np.cos(2 * np.pi * t / (24 * c))
                    + 0.15 * rng.standard_normal(n))
    return np.stack(cols, axis=1)


def _lane_corpus(n=512):
    """Lanes that part ways in the round loop: the test corpus' first
    series, a period-3 wave and an alternating one in noise (both stay
    below tier C's spans, the alternating one stops within a few rounds)
    and a slow sine in faint noise (reaches tier C and the k_small regime
    early)."""
    rng = np.random.default_rng(3)
    t = np.arange(n)
    alt = (-1.0) ** t + 0.3 * rng.standard_normal(n)
    p3 = np.sin(2 * np.pi * t / 3) + 0.3 * rng.standard_normal(n)
    slow = np.sin(2 * np.pi * t / 64) + 0.02 * rng.standard_normal(n)
    return np.stack([_series(n, 0), p3, slow, alt])


def _same_lanes(batch, xs, cfg, **kw):
    """Every lane of the batch result equals compress_rounds of its
    series: kept, iterations and xr equal, deviation exactly equal."""
    for b in range(xs.shape[0]):
        one = tc.compress_rounds(xs[b], cfg, device="cpu", **kw)
        assert torch.equal(batch.kept[b], one.kept), b
        assert int(batch.iters[b]) == int(one.iters), b
        assert torch.equal(batch.xr[b], one.xr), b
        assert float(batch.deviation[b]) == float(one.deviation), b
        assert int(batch.n_kept[b]) == int(one.n_kept), b


# ---------------------------------------------------------------------------
# (a) port against JAX
# ---------------------------------------------------------------------------

def test_compress_batch_matches_reference():
    xs = _corpus()
    jcfg = jc.CameoConfig(eps=0.02, lags=12, mode="rounds")
    want = jc.compress_batch(jnp.asarray(xs), jcfg)
    got = tc.compress_batch(xs, convert.config_from_dict(
        dataclasses.asdict(jcfg)), device="cpu")
    np.testing.assert_array_equal(got.kept.numpy(), np.asarray(want.kept))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_allclose(got.deviation.numpy(),
                               np.asarray(want.deviation), rtol=0,
                               atol=1e-12)
    assert got.kept.shape == (3, 512) and got.stat_orig.shape == (3, 12)


def _carry_mismatch(got, want):
    """Fields that differ: ints/bools exactly, floats beyond 1e-10."""
    bad = []
    for f, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if w.dtype.kind == "f":
            if not np.allclose(g, w, rtol=0.0, atol=1e-10):
                bad.append(f)
        elif not np.array_equal(g, w):
            bad.append(f)
    return bad


def test_batched_round_matches_reference_chunk():
    """One port round (the round loop's grouping over lanes) from JAX's
    batched carry, converted with its lane axis, against one JAX batched
    chunk of one round, on the corpus of test_compress_batch_matches_
    reference: at rounds 0, 10 and 40 every lane is live, at 81 and 84
    lanes have stopped (its lanes take 87, 82 and 80 rounds)."""
    xs = _corpus()
    B, n = xs.shape
    jcfg = jc.CameoConfig(eps=0.02, lags=12, mode="rounds")
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    nb = jc._round_bucket(n, jcfg)
    min_alive, eps = jc._halting_params(n, jcfg)
    nv = jnp.full((B,), n, jnp.int32)
    ma = jnp.full((B,), min_alive, jnp.int32)
    ep = jnp.full((B,), eps)
    carry, p0 = jc._batch_init(jnp.asarray(xs), nv, jcfg)
    probe, body = tc._round_fns(
        tcfg, nb, torch.full((B,), n, dtype=torch.int32),
        torch.full((B,), min_alive, dtype=torch.int32),
        torch.full((B,), eps, dtype=torch.float64), T(p0))
    at = (0, 10, 40, 81, 84)
    for r in range(at[-1] + 1):
        nxt, _ = jc._batch_chunk(carry, nv, ma, ep, p0, cfg=jcfg, budget=1)
        if r in at:
            port = convert.carry_from_numpy(
                [np.asarray(a) for a in carry], "cpu", batched=True)
            got, live = tc._round_step(port, probe, body)
            assert live
            assert _carry_mismatch(convert.carry_to_numpy(got, batched=True),
                                   nxt) == [], r
        carry = nxt
    assert sorted(np.asarray(carry[8]).tolist()) == [80, 82, 85]


MV_CASES = {
    "eps": (dict(), (2048, 3, 0)),
    "eps_c": (dict(eps_c=[2e-2, 1e-3, 2e-2]), (2048, 3, 0)),
    "target_cr": (dict(target_cr=4.0), (1024, 2, 9)),
}


def _mv_case(name):
    """(X, JAX config, eps_c) of a multivariate case."""
    kw, (n, C, seed) = MV_CASES[name]
    cfg = jc.CameoConfig(**{**MV_CFG, **{k: v for k, v in kw.items()
                                         if k != "eps_c"}})
    return _mv_series(n, C=C, seed=seed), cfg, kw.get("eps_c")


def _reference_main(out_path):
    """Subprocess entry: JAX's compress_multivariate on every case, saved
    as npz (the caller picks the compilation through XLA_FLAGS)."""
    jax.config.update("jax_enable_x64", True)
    res = {}
    for name in MV_CASES:
        X, cfg, eps_c = _mv_case(name)
        r = jc.compress_multivariate(X, cfg, eps_c=eps_c)
        for field in ("kept", "xr", "iters", "n_kept", "deviations",
                      "col_n_kept", "deviation"):
            res[f"{name}/{field}"] = np.asarray(getattr(r, field))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def mv_strict(tmp_path_factory):
    """JAX's strict-compiled compress_multivariate results, computed in a
    subprocess when the first test asks for them."""
    out = tmp_path_factory.mktemp("jax_strict_mv") / "strict.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", str(out)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", list(MV_CASES))
def test_compress_multivariate_matches_reference(mv_strict, case):
    X, jcfg, eps_c = _mv_case(case)
    want = {k.split("/")[1]: v for k, v in mv_strict.items()
            if k.startswith(case + "/")}
    got = tc.compress_multivariate(
        X, convert.config_from_dict(dataclasses.asdict(jcfg)), eps_c=eps_c,
        device="cpu")
    assert isinstance(got, tc.MVCompressResult)
    assert got.kept.dtype == np.bool_ and got.xr.shape == X.shape
    np.testing.assert_array_equal(got.kept, want["kept"])
    np.testing.assert_array_equal(got.xr, want["xr"])
    assert got.iters == int(want["iters"])
    assert got.n_kept == int(want["n_kept"])
    np.testing.assert_array_equal(got.col_n_kept, want["col_n_kept"])
    np.testing.assert_allclose(got.deviations, want["deviations"], rtol=0,
                               atol=1e-12)
    assert abs(got.deviation - float(want["deviation"])) <= 1e-12
    if jcfg.target_cr is None:
        budget = eps_c if eps_c is not None else [jcfg.eps] * X.shape[1]
        assert np.all(got.deviations <= np.asarray(budget) + 1e-12)


def test_compress_multivariate_default_jit_near_tie():
    """ROADMAP.md C7: JAX's default compilation parts from the port (and
    from its own strict compilation) on the first multivariate case in
    round 0 of columns 0 and 2, at a float32 ranking near-tie; column 1
    agrees with it exactly."""
    X, jcfg, _ = _mv_case("eps")
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    for c, parts in ((0, True), (1, False), (2, True)):
        want = jc.compress_rounds(jnp.asarray(X[:, c]), jcfg)
        got = tc.compress_rounds(X[:, c], tcfg, device="cpu")
        same = np.array_equal(got.kept.numpy(), np.asarray(want.kept))
        assert same != parts, c


def test_compress_multivariate_validates_inputs():
    X = _mv_series(512, C=2, seed=9)
    cfg = tc.CameoConfig(**MV_CFG)
    with pytest.raises(ValueError, match="eps_c"):
        tc.compress_multivariate(X, cfg, eps_c=[1e-2], device="cpu")
    with pytest.raises(ValueError, match="eps_c"):
        tc.compress_multivariate(X, cfg, eps_c=[1e-2, -1.0], device="cpu")
    with pytest.raises(ValueError, match=r"\[n, C\]"):
        tc.compress_multivariate(np.zeros(100), cfg, device="cpu")


def test_compress_batch_validates_inputs(monkeypatch):
    with pytest.raises(ValueError, match="rounds"):
        tc.compress_batch(np.zeros((2, 64)), tc.CameoConfig(
            mode="sequential"), device="cpu")
    with pytest.raises(ValueError, match=r"\[B, n\]"):
        tc.compress_batch(np.zeros(64), tc.CameoConfig(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tc.compress_batch(np.zeros((2, 64)), tc.CameoConfig(), mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tc.compress_batch(_corpus(128, 2), tc.CameoConfig()),
                 lambda: tc.compress_multivariate(
                     _mv_series(256, C=2), tc.CameoConfig(**MV_CFG))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# (b) lanes against per-series runs in the port
# ---------------------------------------------------------------------------

LANE_CASES = {
    "window": dict(),
    "single": dict(rank="single"),
    "bisect": dict(select="bisect"),
    "scan": dict(select="scan"),
    "first_violation": dict(stop_policy="first_violation"),
    "kappa4": dict(kappa=4),
    "target_cr": dict(target_cr=6.0),
}


@pytest.mark.parametrize("name", list(LANE_CASES))
def test_lanes_match_per_series(name):
    xs = _corpus()
    cfg = tc.CameoConfig(eps=0.02, lags=12, **LANE_CASES[name])
    _same_lanes(tc.compress_batch(xs, cfg, device="cpu"), xs, cfg)


def test_lanes_match_per_series_pad_to_and_trim():
    """pad_to forces a larger bucket for every lane; at kappa > 1 the
    batch trims the tail remainder as compress() does."""
    xs = _corpus(500)
    cfg = tc.CameoConfig(eps=0.02, lags=12)
    res = tc.compress_batch(xs, cfg, pad_to=640, device="cpu")
    assert res.kept.shape == (3, 500)
    _same_lanes(res, xs, cfg, pad_to=640)
    cfg4 = tc.CameoConfig(eps=0.02, lags=12, kappa=4)
    res4 = tc.compress_batch(_corpus(502), cfg4, device="cpu")
    assert res4.kept.shape == (3, 500)
    _same_lanes(res4, _corpus(502)[:, :500], cfg4)


def test_lanes_match_per_series_greedy_scan():
    """select="scan" dispatched as on the card (the greedy walk through
    prefix_devs' plain version, a lane axis on every argument)."""
    import chip_smoke
    xs = _corpus()
    cfg = tc.CameoConfig(eps=0.02, lags=12, select="scan")
    with chip_smoke.card_dispatch(torch.device("cpu")):
        _same_lanes(tc.compress_batch(xs, cfg, device="cpu"), xs, cfg)


# ---------------------------------------------------------------------------
# (c) the round loop's lane groups
# ---------------------------------------------------------------------------

def test_round_loop_groups_lanes(monkeypatch):
    """The lane corpus: lanes leave the working set at different rounds,
    a round runs both the k_small and the k_max group, and some lanes reach
    tier C while others do not; each lane still equals its per-series
    run."""
    xs = _lane_corpus()
    cfg = tc.CameoConfig(eps=0.02, lags=12)
    calls, saw_c = [], []
    make = tc._round_fns

    def recording(*a, **kw):
        probe, body = make(*a, **kw)

        def rec_probe(c):
            calls.append("probe")
            saw_c[:] = c[12].tolist()
            return probe(c)

        def rec_body(c, small=False, lanes=None):
            calls.append((small, c[0].shape[0]))
            return body(c, small=small, lanes=lanes)
        return rec_probe, rec_body
    monkeypatch.setattr(tc, "_round_fns", recording)
    res = tc.compress_batch(xs, cfg, device="cpu")
    monkeypatch.undo()
    rounds, cur = [], []
    for c in calls[1:]:
        if c == "probe":
            rounds.append(cur)
            cur = []
        else:
            cur.append(c)
    B = xs.shape[0]
    iters = res.iters.tolist()
    assert len(set(iters)) == B and len(rounds) == max(iters)
    assert any(len(r) == 2 and {s for s, _ in r} == {True, False}
               for r in rounds), "no round ran both lane groups"
    assert any(sum(k for _, k in r) < B for r in rounds), \
        "no lane left the working set"
    assert True in saw_c and False in saw_c, saw_c
    _same_lanes(res, xs, cfg)


# ---------------------------------------------------------------------------
# (d) the kernels' lane axis
# ---------------------------------------------------------------------------

def _lanes_setup(B=3, n=384, L=12, kappa=1, seed=0):
    """B series zero-padded beyond ny, their tables, ACFs and Eq. 8
    deltas, as the round body hands them to the kernels."""
    rng = np.random.default_rng(seed)
    nyb = n // kappa
    ny = nyb - 16
    ys, tabs, p0s = [], [], []
    for b in range(B):
        y = np.zeros(nyb)
        y[:ny] = _series(ny, seed=seed + b)
        agg = extract_aggregates(T(y[:ny]), L, backend="reference")
        tab = torch.stack(list(agg))
        ys.append(T(y))
        tabs.append(tab)
        p0s.append(acf_from_aggregates(tab, ny))
    dval = T(0.05 * rng.standard_normal((B, n)))
    return (torch.stack(ys), torch.stack(tabs), torch.stack(p0s), dval,
            torch.full((B,), ny, dtype=torch.int32), rng)


def _window_args(y, tab, p0, ny, rng, K=20, Wy=8, dt=torch.float32):
    B = y.shape[0]
    starts = T(rng.integers(0, int(ny[0]) - Wy, (B, K)).astype(np.int32))
    dyws = T(0.1 * rng.standard_normal((B, K, Wy))).to(dt)
    return (y.to(dt), dyws, starts, tab.to(dt), ny, p0.to(dt))


@pytest.mark.parametrize("kappa", [1, 4])
def test_acf_impact_plain_lanes(kappa):
    y, tab, p0, dval, ny, _ = _lanes_setup(kappa=kappa)
    for measure in ("mae", "rmse", "cheb"):
        got = acf_impact_plain(y, dval, tab, p0, L=12, measure=measure,
                               ny=ny, kappa=kappa)
        for b in range(y.shape[0]):
            one = acf_impact_plain(y[b], dval[b], tab[b], p0[b], L=12,
                                   measure=measure, ny=ny[b], kappa=kappa)
            assert torch.equal(got[b], one), (measure, b)


def test_window_rows_plain_lanes():
    y, tab, p0, _, ny, rng = _lanes_setup()
    args = _window_args(y, tab, p0, ny, rng)
    for measure in ("mae", "rmse", "cheb"):
        got = t_fused.window_rows_plain(*args, L=12, measure=measure)
        for b in range(y.shape[0]):
            one = t_fused.window_rows_plain(*(a[b] for a in args), L=12,
                                            measure=measure)
            assert torch.equal(got[b], one), (measure, b)


@pytest.mark.parametrize("greedy", [False, True])
def test_prefix_devs_plain_lanes(greedy):
    y, tab, p0, _, ny, rng = _lanes_setup()
    y64, d, st, t64, _, p64 = _window_args(y, tab, p0, ny, rng, K=16,
                                           dt=torch.float64)
    ok = T(rng.random((3, 16)) > 0.25)
    eps = torch.full((3,), 0.004, dtype=torch.float64)
    got = t_fused.prefix_devs_plain(y64, d, st, ok, t64, p64, ny, eps, L=12,
                                    greedy=greedy)
    for b in range(3):
        one = t_fused.prefix_devs_plain(y64[b], d[b], st[b], ok[b], t64[b],
                                        p64[b], ny[b], eps[b], L=12,
                                        greedy=greedy)
        assert torch.equal(got[b], one), b


def test_lag_dot_plain_lanes():
    y = T(np.random.default_rng(2).standard_normal((4, 300)))
    got = lag_dot_plain(y, L=9)
    assert got.shape == (4, 9)
    for b in range(4):
        assert torch.equal(got[b], lag_dot_plain(y[b], L=9)), b


def test_lag_dot_plain_cross_lanes():
    """The dense update's bilinear term: lag_dot's cross form on lanes, each
    lane the bits of its one-lane ``[1, n]`` call."""
    rng = np.random.default_rng(3)
    a, b = (T(rng.standard_normal((4, 300))) for _ in range(2))
    got = lag_dot_plain(a, b, L=9)
    assert got.shape == (4, 9)
    for k in range(4):
        assert torch.equal(got[k], lag_dot_plain(a[k:k + 1], b[k:k + 1],
                                                 L=9)[0]), k
    want = torch.stack([torch.stack([torch.sum(a[k, :300 - l] * b[k, l:])
                                     for l in range(1, 10)])
                        for k in range(4)])
    assert float(torch.max(torch.abs(got - want))) <= 1e-12


# row lengths around XLA's 16-value groups and the kernel's 4,096-value
# tiles, uk_elec's rows and a row past 16 tiles (levels 0-4)
XLA_LENGTHS = (1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 18432, 65537)
_jnp_cumsum = jax.jit(lambda a: jnp.cumsum(a, axis=-1))


def _rows(n, dt, seed, rows=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)) * 10.0 ** rng.uniform(-6, 6, (rows, n))
    return x.astype(dt)


def _bits_equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(got.view(np.uint8),
                                                      want.view(np.uint8))


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", XLA_LENGTHS)
def test_prefix_sum_plain_is_xla_order(dt, n):
    """prefix_sum's order is jnp.cumsum's (XLA's base-16 blocked scan, in
    the row's own type): the plain version and the CPU wrapper equal
    jax.jit(jnp.cumsum) bit for bit, on one row and on [3, n], each row
    also alone."""
    x = _rows(n, dt, n)
    want = _jnp_cumsum(x)
    xt = torch.from_numpy(x)
    assert _bits_equal(prefix_sum_plain(xt), want)
    assert _bits_equal(prefix_sum_cuda(xt), want)
    assert _bits_equal(prefix_sum_plain(xt[1]), _jnp_cumsum(x[1]))
    for r in range(3):
        assert _bits_equal(prefix_sum_plain(xt[r]), np.asarray(want)[r]), r


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_prefix_sum_plain_signed_zeros(dt):
    """-0 and +0 sum as XLA sums them: every chain starts from +0, so no
    sum is -0, whatever the zeros' signs."""
    x = np.array([[-0.0, -0.0, 1.0, -1.0, -0.0, 0.0] * 700,
                  [-0.0] * 4200], dtype=dt)
    want = _jnp_cumsum(x)
    assert _bits_equal(prefix_sum_plain(torch.from_numpy(x)), want)
    assert not np.signbit(np.asarray(want)).any()


def _kernel_schedule(x: torch.Tensor) -> torch.Tensor:
    """csrc/prefix_sum.cu's arithmetic on one row, tile by tile: each 4,096-
    value tile's levels 0-2 (one chain a 16-value group), the published
    values (total, level-2 partial 14, level-1 partial 255), every block's
    scan of the tile totals (the plain version's order over them), the
    carries of each tile and its three-add downsweep."""
    n, tile = x.shape[0], 4096
    nt = -(-n // tile)
    xp = torch.nn.functional.pad(x, (0, nt * tile - n)).view(nt, tile)

    def chain(v):                        # [..., 16], from +0, one at a time
        acc, out = torch.zeros_like(v[..., 0]), []
        for k in range(16):
            acc = acc + v[..., k]
            out.append(acc)
        return torch.stack(out, -1)
    inb0 = chain(xp.view(nt, 256, 16))
    inb1 = chain(inb0[..., 15].reshape(nt, 16, 16))
    inb2 = chain(inb1[..., 15])
    total, l2_14, l1_255 = inb2[:, 15], inb2[:, 14], inb1[:, 15, 15]
    p3 = prefix_sum_plain(total)
    zero = torch.zeros((), dtype=x.dtype)
    out = []
    for t in range(nt):
        q = p3[t - 2] if t >= 2 else zero
        c3 = p3[t - 1] if t >= 1 else zero
        c2 = total[t - 1] + q if t >= 1 else zero
        c1 = l1_255[t - 1] + (l2_14[t - 1] + q) if t >= 1 else zero
        p2 = inb2[t] + c3
        p1 = inb1[t] + torch.cat([c2.view(1), p2[:15]])[:, None]
        before = torch.cat([c1.view(1), p1.reshape(256)[:255]])
        out.append((inb0[t] + before[:, None]).reshape(tile))
    return torch.cat(out)[:n]


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 17, 4097, 18432, 65537, 200000])
def test_prefix_sum_kernel_schedule_is_xla_order(dt, n):
    """The kernel's tiles and carries (modelled on the CPU: the kernel runs
    only on a card) give jnp.cumsum's bits: one tile, two, uk_elec's five,
    17 tiles (two levels above the tiles) and 49 (a block reads tiles
    again)."""
    x = _rows(n, dt, n, rows=1)[0]
    assert _bits_equal(_kernel_schedule(torch.from_numpy(x)),
                       _jnp_cumsum(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_gpu_prefix_sum_lanes(cuda, dt):
    """The kernel equals its plain version on the CPU bit for bit and each
    lane its one-lane launch: XLA's group and tile boundaries, the main
    path's pairs (uk_elec one series and B = 16, aus_elec), a cluster of 8
    blocks with one tile each and with a second round (32,768 / 32,769), all
    tiles kept in shared memory and one more, read again (float64 196,608 /
    196,609; float32 393,217), and aus_elec's full bucket."""
    shapes = [(3, n) for n in XLA_LENGTHS] + [
        (2, 18432), (32, 18432), (2, 5120), (8, 5120), (2, 32768),
        (2, 32769), (2, 196608), (2, 196609), (1, 393217), (2, 245760)]
    for shape in shapes:
        rng = np.random.default_rng(shape[1])
        x = torch.from_numpy(rng.standard_normal(shape) * 10.0 ** rng.uniform(
            -6, 6, shape)).to(cuda, dt)
        got = prefix_sum_cuda(x)
        assert torch.equal(got.cpu(), prefix_sum_plain(x.cpu())), shape
        for b in range(shape[0]):
            assert torch.equal(got[b], prefix_sum_cuda(x[b])), (shape, b)


@pytest.mark.gpu
def test_gpu_lag_dot_cross_lanes(cuda):
    """The cross form on lanes: within 1e-10 of the plain version and each
    lane the bits of its one-lane launch."""
    for n, L in ((18432, 48), (5120, 7), (700, 9)):
        rng = np.random.default_rng(n)
        a, b = (T(rng.standard_normal((5, n))).to(cuda) for _ in range(2))
        got = lag_dot_cuda(a, b, L=L)
        want = lag_dot_plain(a, b, L=L)
        assert float(torch.max(torch.abs(got - want))) <= \
            1e-10 * float(torch.max(torch.abs(want)))
        for k in range(5):
            assert torch.equal(got[k], lag_dot_cuda(a[k:k + 1], b[k:k + 1],
                                                    L=L)[0])
            assert torch.equal(got[k], lag_dot_cuda(a[k], b[k], L=L))


@pytest.mark.gpu
def test_gpu_lag_dot_lanes(cuda):
    for n, L in ((18432, 48), (5120, 7), (700, 9)):
        y = T(np.random.default_rng(n).standard_normal((5, n))).to(cuda)
        got = lag_dot_cuda(y, L=L)
        want = lag_dot_plain(y, L=L)
        assert float(torch.max(torch.abs(got - want))) <= \
            1e-10 * float(torch.max(torch.abs(want)))
        for b in range(5):
            assert torch.equal(got[b], lag_dot_cuda(y[b].contiguous(), L=L))
        assert torch.equal(got, lag_dot_cuda(y, L=L))


@pytest.mark.gpu
@pytest.mark.parametrize("kappa,L", [(1, 12), (1, 48), (4, 7), (48, 7)])
def test_gpu_acf_impact_lanes(cuda, kappa, L):
    y, tab, p0, dval, ny, _ = _lanes_setup(B=5, n=48 * 64, L=L, kappa=kappa)
    for dt in (torch.float32, torch.float64):
        args = [a.to(cuda, dt).contiguous() for a in (y, dval, tab, p0)]
        nyc = ny.to(cuda)
        for measure in ("mae", "rmse", "cheb"):
            got = acf_impact_cuda(*args, L=L, measure=measure, ny=nyc,
                                  kappa=kappa)
            want = acf_impact_plain(*args, L=L, measure=measure, ny=nyc,
                                    kappa=kappa)
            assert torch.equal(got, want), (dt, measure)
            for b in range(5):
                one = acf_impact_cuda(*(a[b] for a in args), L=L,
                                      measure=measure, ny=nyc[b:b + 1],
                                      kappa=kappa)
                assert torch.equal(got[b], one), (dt, measure, b)


@pytest.mark.gpu
@pytest.mark.parametrize("L,Wy", [(12, 8), (48, 64), (7, 3)])
def test_gpu_window_rows_lanes(cuda, L, Wy):
    y, tab, p0, _, ny, rng = _lanes_setup(B=5, n=2048, L=L)
    args = tuple(a.to(cuda).contiguous()
                 for a in _window_args(y, tab, p0, ny, rng, K=300, Wy=Wy))
    for measure in ("mae", "rmse", "cheb"):
        got = t_fused.window_rows_cuda(*args, L=L, measure=measure)
        assert torch.equal(got, t_fused.window_rows_plain(
            *args, L=L, measure=measure)), measure
        for b in range(5):
            one = t_fused.window_rows_cuda(
                args[0][b], args[1][b], args[2][b], args[3][b],
                args[4][b:b + 1], args[5][b], L=L, measure=measure)
            assert torch.equal(got[b], one), (measure, b)


@pytest.mark.gpu
@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("L,nyb", [(12, 2048), (48, 40000)])
def test_gpu_prefix_devs_lanes(cuda, greedy, L, nyb):
    """One block a lane, z in shared memory (nyb 2,048) and in global
    scratch (nyb 40,000)."""
    y, tab, p0, _, ny, rng = _lanes_setup(B=3, n=nyb, L=L)
    y64, d, st, t64, _, p64 = (a.to(cuda).contiguous() for a in _window_args(
        y, tab, p0, ny, rng, K=200, Wy=16, dt=torch.float64))
    ok = T(rng.random((3, 200)) > 0.25).to(cuda)
    nyc = ny.to(cuda)
    curve = t_fused.prefix_devs_cuda(y64, d, st, ok, t64, p64, nyc, L=L)
    eps = torch.sort(curve, dim=-1).values[:, 100].contiguous()
    for measure in ("mae", "rmse", "cheb"):
        kw = dict(L=L, measure=measure, greedy=greedy)
        got = t_fused.prefix_devs_cuda(y64, d, st, ok, t64, p64, nyc, eps,
                                       **kw)
        assert torch.equal(got, t_fused.prefix_devs_plain(
            y64, d, st, ok, t64, p64, nyc, eps, **kw)), measure
        for b in range(3):
            one = t_fused.prefix_devs_cuda(
                y64[b], d[b], st[b], ok[b], t64[b], p64[b], nyc[b:b + 1],
                eps[b:b + 1], **kw)
            assert torch.equal(got[b], one), (measure, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["window", "scan", "kappa4"])
def test_gpu_compress_batch_lanes(cuda, name):
    """compress_batch on the card: every lane equals its per-series card
    run (kept, iterations and the deviation's bits) on the lane corpus."""
    xs = _lane_corpus(1024)
    cfg = tc.CameoConfig(eps=0.02, lags=12, **LANE_CASES[name])
    res = tc.compress_batch(xs, cfg)
    assert res.kept.device.type == "cuda"
    for b in range(xs.shape[0]):
        one = tc.compress_rounds(xs[b], cfg)
        assert torch.equal(res.kept[b], one.kept), b
        assert int(res.iters[b]) == int(one.iters), b
        assert float(res.deviation[b]) == float(one.deviation), b


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_main(sys.argv[2])
