"""The port's kernels: each plain PyTorch version against the JAX package's
Pallas kernel in interpret mode (CPU), the backend dispatch, Python models
of the acf_impact and lag_dot kernels' schedules (``csrc/acf_impact.cu``:
lanes, placement and the in-order reduction; ``csrc/lag_dot.cu``: tiles,
lanes, the shuffle tree and the blocks in order), and — on a card only —
each CUDA kernel against its plain version at the main path's shapes.

Tolerances: lag_dot float64 1e-10 and float32 2e-4, both scaled by
max|out| as in ``tests/test_kernels.py``; window_rows and acf_impact
float32 1e-4 against the Pallas kernels (float32 sums in other orders),
float64 1e-10.  The acf_impact schedule equals its plain version exactly
(tolerance 0), and so does the kernel on the card; window_rows on the card
is held at rtol 1e-4 with an absolute floor of 1e-6 x max|plain|, so an
output of the wrong scale fails at any input size (its exact checks are in
``tests/test_torch_window_kernels.py``).
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.acf import acf_from_aggregates, extract_aggregates
from repro.kernels import fused_round as j_fused
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.acf_impact import acf_impact_pallas
from repro.kernels.lag_dot import lag_dot_pallas
from repro_torch.core import acf as t_acf
from repro_torch.core import cameo as t_cameo
from repro_torch.kernels import fused_round as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.acf_impact import acf_impact_cuda, acf_impact_plain
from repro_torch.kernels.lag_dot import extended_operand as lag_dot_ext
from repro_torch.kernels.lag_dot import lag_dot_cuda, lag_dot_plain
from test_torch_lag_order import row_sum_walk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it:
    these shapes gain nothing from more, and under pytest-xdist a worker's
    first multi-threaded computation has given one thread's chunk of
    ``acf_impact_plain`` wrong values (ROADMAP C6)."""
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


def _series(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (np.sin(2 * np.pi * np.arange(n) / 24)
            + 0.2 * rng.standard_normal(n)).astype(dtype), rng


def _tables(y, L, ny=None):
    ny = y.shape[0] if ny is None else ny
    agg = extract_aggregates(jnp.asarray(y[:ny]), L)
    table = np.stack(list(agg)).astype(y.dtype)
    p0 = np.asarray(acf_from_aggregates(agg, ny)).astype(y.dtype)
    return table, p0


# ---------------------------------------------------------------------------
# lag_dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,L,block", [
    (256, 8, 128), (5000, 64, 512), (4096, 365, 2048), (777, 3, 256)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lag_dot_plain_matches_pallas(n, L, block, dtype):
    y, _ = _series(n, dtype, seed=1)
    want = np.asarray(lag_dot_pallas(jnp.asarray(y), L=L, block=block,
                                     interpret=True))
    got = lag_dot_cuda(T(y), L=L)          # CPU tensor: the plain version
    assert got.dtype == T(y).dtype
    tol = 2e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * float(np.max(np.abs(want))))


@pytest.mark.parametrize("n,L", [(512, 12), (1000, 24)])
def test_lag_dot_cross_and_halo(n, L):
    rng = np.random.default_rng(3)
    a, b, halo = (rng.standard_normal(n), rng.standard_normal(n),
                  rng.standard_normal(L))
    want = np.asarray(lag_dot_pallas(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(halo), L=L, block=256,
                                     interpret=True))
    for got in (lag_dot_cuda(T(a), T(b), T(halo), L=L),
                t_ops.lag_dot(T(a), L, b=T(b), halo=T(halo)),
                t_ops.lag_dot(T(a), L, b=T(b), halo=T(halo),
                              backend="reference")):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# window_rows (fused_round)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,Wy,nyb,ny,K", [
    (4, 16, 128, 120, 7), (12, 16, 128, 120, 7), (48, 64, 512, 500, 5)])
def test_window_rows_plain_matches_pallas(L, Wy, nyb, ny, K):
    rng = np.random.default_rng(3)
    y = np.zeros(nyb, np.float32)
    y[:ny] = rng.standard_normal(ny)
    dyws = (0.1 * rng.standard_normal((K, Wy))).astype(np.float32)
    starts = rng.integers(0, ny - Wy, size=K).astype(np.int32)
    table, _ = _tables(y, L, ny)
    want = np.asarray(j_fused.window_rows_pallas(
        jnp.asarray(y), jnp.asarray(dyws), jnp.asarray(starts),
        jnp.asarray(table), ny, L=L, interpret=True))
    ny_t = torch.tensor(ny, dtype=torch.int32)
    args = (T(y), T(dyws), T(starts), T(table), ny_t)
    rows = t_fused.window_acf_rows(*args, L=L)
    np.testing.assert_allclose(rows.numpy(), want, rtol=1e-4, atol=1e-4)
    # the wrapper's form (the one the kernel computes): each row reduced to
    # its deviation from p0, against measure_rows over the Pallas rows
    p0 = (0.5 * rng.standard_normal(L)).astype(np.float32)
    for measure in ("mae", "rmse", "cheb"):
        imp = t_fused.window_rows_cuda(*args, T(p0), L=L, measure=measure)
        np.testing.assert_allclose(
            imp.numpy(), np.asarray(j_ref.measure_rows(want, p0, measure)),
            rtol=1e-4, atol=1e-4)
    # float64 plain form against the JAX einsum contraction, tightly
    y64, d64, tab64 = y.astype(np.float64), dyws.astype(np.float64), \
        table.astype(np.float64)
    want64 = j_fused.window_acf_rows(jnp.asarray(y64), jnp.asarray(d64),
                                     jnp.asarray(starts), jnp.asarray(tab64),
                                     ny, L=L)
    got64 = t_fused.window_acf_rows(T(y64), T(d64), T(starts), T(tab64),
                                    ny_t, L=L)
    np.testing.assert_allclose(got64.numpy(), np.asarray(want64),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("L", [1, 4, 12])
def test_moment_deltas_forms(L):
    """Shift-view contraction ≡ its slice-loop oracle ≡ the JAX form."""
    rng = np.random.default_rng(7 * L)
    nyb, ny, K, Wy = 96, 90, 5, 8
    y = np.zeros(nyb)
    y[:ny] = rng.standard_normal(ny)
    starts = rng.integers(0, ny - Wy, size=K).astype(np.int32)
    d = 0.3 * rng.standard_normal((K, Wy))
    ctx = t_fused.candidate_context(T(y), T(starts), L=L, Wy=Wy)
    got = t_fused._moment_deltas(T(d), ctx, T(starts), ny, L=L)
    oracle = t_fused._moment_deltas_ref(T(d), ctx, T(starts), ny, L=L)
    want = j_fused._moment_deltas_ref(jnp.asarray(d), jnp.asarray(ctx.numpy()),
                                      jnp.asarray(starts), ny, L=L)
    for a in (got, oracle):
        np.testing.assert_allclose(a.numpy(), np.asarray(want),
                                   rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(
        t_fused.solo_moment_rows(T(y), T(d), T(starts), ny, L=L).numpy(),
        np.asarray(j_fused.solo_moment_rows(jnp.asarray(y), jnp.asarray(d),
                                            jnp.asarray(starts), ny, L=L)),
        rtol=1e-11, atol=1e-11)


# ---------------------------------------------------------------------------
# acf_impact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
def test_acf_impact_full_length_matches_pallas(measure):
    n, L = 1000, 24
    y, rng = _series(n, np.float32)
    table, p0 = _tables(y, L)
    dval = (0.1 * rng.standard_normal(n)).astype(np.float32)
    want = np.asarray(acf_impact_pallas(
        jnp.asarray(y), jnp.asarray(dval), jnp.asarray(table),
        jnp.asarray(p0), L=L, measure=measure, block=256, interpret=True))
    got = acf_impact_cuda(T(y), T(dval), T(table), T(p0), L=L,
                          measure=measure)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
def test_acf_impact_runtime_ny_kappa(measure):
    """The rounds mode's form: zero-padded y with runtime ny < nyb and the
    x → y map i // kappa, against single_impacts' jnp form."""
    kappa, nyb, ny, L = 4, 160, 150, 12
    y, rng = _series(nyb, np.float32, seed=5)
    y[ny:] = 0.0
    table, p0 = _tables(y, L, ny)
    P = nyb * kappa
    dval = (0.05 * rng.standard_normal(P)).astype(np.float32)
    idx = jnp.arange(P, dtype=jnp.int32) // kappa
    rows = jax.jit(lambda *a: j_ref.acf_after_single_delta(*a[:4], ny=a[4]))(
        jnp.asarray(table), jnp.asarray(y), idx, jnp.asarray(dval),
        jnp.asarray(ny, jnp.int32))
    want = np.asarray(j_ref.measure_rows(rows, jnp.asarray(p0), measure))
    ny_t = torch.tensor(ny, dtype=torch.int32)
    for got in (acf_impact_cuda(T(y), T(dval), T(table), T(p0), L=L,
                                measure=measure, ny=ny_t, kappa=kappa),
                acf_impact_plain(T(y), T(dval), T(table), T(p0), L=L,
                                 measure=measure, ny=ny_t, kappa=kappa)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the kernels' schedules, modelled on the CPU
# ---------------------------------------------------------------------------

N_SM = 132                      # the H100's SMs (win::plan asks the card)
K_BLOCK, K_SMEM = 256, 232448   # win::kBlock, win::kSmemLimit


def _win_plan(P, lanes, cand_bytes, n_sm, fixed_bytes=0):
    """``win::plan`` (csrc/window.cuh) for P candidates of ``lanes`` lanes
    and ``cand_bytes`` of shared memory each, beside ``fixed_bytes``."""
    fit = (K_SMEM - fixed_bytes) // cand_bytes
    if lanes <= 32:
        G, cpu, U = lanes, min(32 // lanes, fit), 32
        most = min(fit // cpu, K_BLOCK // 32)
    else:
        G = 32 * min(-(-lanes // 32), K_BLOCK // 32)
        cpu, U = 1, G
        most = min(fit, K_BLOCK // U)
    units = max(1, min(most, -(-P // (cpu * n_sm))))
    D = G if lanes <= 32 else G // 32
    return dict(G=G, cpu=cpu, cpb=units * cpu, M=-(-65536 // D),
                blocks=-(-P // (units * cpu)), threads=units * U)


def _win_slot(tid, lanes, G, cpu, M):
    """``win::slot``: (candidate in the block, lane, active)."""
    w, lane = tid >> 5, tid & 31
    if lanes <= 32:
        q = (lane * M) >> 16
        return w * cpu + q, lane - q * G, q < cpu
    q = (w * M) >> 16
    return q, tid - q * G, True


def _acf_impact_schedule(y, dval, table, p0, *, L, measure, ny, kappa,
                         n_sm):
    """``csrc/acf_impact.cu``'s schedule on a card of ``n_sm`` SMs holding
    2,048 threads each at once: the launch's lanes a candidate (one a lag
    where that fits the card at once, else the most, a power of two with
    at least two lags a lane, that fit), the placement of win::plan and
    win::slot, yi = p / kappa by the multiply and shift, every (candidate,
    lag) term formed once by its lane with the plain version's elementwise
    arithmetic, then each candidate's terms taken in lag order (a max for
    cheb, rn::row_sum's walk for mae and rmse; by its own thread at one lane
    a candidate, else by thread c of its block).
    Returns the impacts and the lanes a candidate."""
    P = dval.shape[0]
    fill = 2048 * n_sm
    per_lag = 32 // (32 // L) if L <= 32 else 32 * min(-(-L // 32), 8)
    lanes = L
    if P * per_lag > fill:
        lanes = 1
        while 4 * lanes <= L and P * lanes * 2 <= fill:
            lanes *= 2
    item = dval.element_size()
    row = 0 if lanes == 1 else (L | 1)
    pl = _win_plan(P, lanes, (row + 1) * item, n_sm, (8 * L + 2) * item)
    kshift = 31 + max(kappa - 1, 0).bit_length()
    kmul = (1 << kshift) // kappa + 1
    owner = np.full((P, L), -1)
    for b in range(pl["blocks"]):
        for tid in range(pl["threads"]):
            cand, r, active = _win_slot(tid, lanes, pl["G"], pl["cpu"],
                                        pl["M"])
            p = b * pl["cpb"] + cand
            if not active or p >= P:
                continue
            assert (p * kmul) >> kshift == p // kappa
            lags = np.arange(r + 1, L + 1, pl["G"]) - 1
            assert (owner[p, lags] == -1).all()
            owner[p, lags] = b * K_BLOCK + tid
        # the reducers: thread c < cpb of the block takes candidate c (at
        # one lane a candidate, that is the candidate's own thread)
        assert pl["cpb"] <= pl["threads"]
    assert (owner >= 0).all()
    idx = torch.arange(P, dtype=torch.int32) // kappa
    rows = t_ref.acf_after_single_delta(table, y, idx, dval, ny=ny)
    diff = rows - p0[None, :]
    terms = diff * diff if measure == "rmse" else torch.abs(diff)
    if measure == "cheb":
        acc = torch.zeros(P, dtype=dval.dtype)
        for lag in range(L):
            t = terms[:, lag]
            acc = torch.where(acc > t, acc, t)
    else:
        acc = row_sum_walk(list(terms.T))
    if measure != "cheb":
        acc = t_ref.div_exact(acc, L)
        acc = t_ref.sqrt_rn(acc) if measure == "rmse" else acc
    return acc, lanes


@pytest.mark.parametrize("n_sm,regime", [(N_SM, "lag"), (8, "split"),
                                          (1, "solo")])
@pytest.mark.parametrize("L", [7, 40])
@pytest.mark.parametrize("kappa", [1, 48])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_acf_impact_schedule_exact(dtype, kappa, L, n_sm, regime):
    """The kernel's schedule equals the plain version bit for bit in its
    three regimes: one lane a lag (the H100's 132 SMs at these small P), a
    power of two lanes with several lags each (an 8-SM card) and one lane a
    candidate (a one-SM card: P fills it), under mae, rmse and cheb; and
    holds against JAX: the Pallas kernel in interpret mode at kappa = 1 (no
    padding), single_impacts' jnp form at kappa = 48 (a zero-padded
    bucket, runtime ny)."""
    nyb = 1100 if kappa == 1 else L + 20
    ny = nyb if kappa == 1 else nyb - 4
    y, rng = _series(nyb, dtype, seed=L + kappa)
    y[ny:] = 0
    table, p0 = _tables(y, L, ny)
    P = nyb * kappa
    dval = (0.05 * rng.standard_normal(P)).astype(dtype)
    ny_t = torch.tensor(ny, dtype=torch.int32)
    args = (T(y), T(dval), T(table), T(p0))
    tol = 1e-4 if dtype == np.float32 else 1e-10
    for measure in ("mae", "rmse", "cheb"):
        kw = dict(L=L, measure=measure, ny=ny_t, kappa=kappa)
        want = acf_impact_plain(*args, **kw)
        got, lanes = _acf_impact_schedule(*args, n_sm=n_sm, **kw)
        assert {"lag": lanes == L, "solo": lanes == 1,
                "split": 1 <= lanes <= L}[regime]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if kappa == 1:
            ref = np.asarray(acf_impact_pallas(
                jnp.asarray(y), jnp.asarray(dval), jnp.asarray(table),
                jnp.asarray(p0), L=L, measure=measure, block=256,
                interpret=True))
        else:
            idx = jnp.arange(P, dtype=jnp.int32) // kappa
            ref = np.asarray(j_ref.measure_rows(
                j_ref.acf_after_single_delta(
                    jnp.asarray(table), jnp.asarray(y), idx,
                    jnp.asarray(dval), ny=jnp.asarray(ny, jnp.int32)),
                jnp.asarray(p0), measure))
        np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


def _lag_dot_schedule(a, b_ext, L, tile=1024):
    """``csrc/lag_dot.cu``'s order: one thread a lag, its products
    a[t] b_ext[t + l] chained one add at a time from +0, tile after tile of
    ``tile`` points staged in shared memory, t first to last."""
    n = a.shape[0]
    acc = torch.zeros(L, dtype=a.dtype)
    lags = torch.arange(1, L + 1)
    for t0 in range(0, n, tile):
        for t in range(t0, min(t0 + tile, n)):
            acc = acc + a[t] * b_ext[t + lags]
    return acc


@pytest.mark.parametrize("form", ["self", "cross", "halo", "halo_lanes"])
@pytest.mark.parametrize("n", [300, 512, 1500, 2048])
def test_lag_dot_schedule_matches_plain(n, form):
    """The kernel's order (n below, at and above one tile) equals the plain
    version bit for bit, for the self, cross (b=) and halo (halo=) forms,
    and for the halo form on lanes (a, b [B, n], halo [B, L]: the
    partitioned mode's T partitions in one launch), each lane as alone."""
    L = 24
    rng = np.random.default_rng(n)
    B = 3 if form == "halo_lanes" else 1
    a = T(rng.standard_normal((B, n)))
    b = T(rng.standard_normal((B, n))) if form != "self" else None
    halo = T(rng.standard_normal((B, L + 3))) if "halo" in form else None
    if B == 1:
        a, b, halo = (None if v is None else v[0] for v in (a, b, halo))
        want = lag_dot_plain(a, b, halo, L=L)
        got = _lag_dot_schedule(a, lag_dot_ext(a, b, halo, L=L), L)
    else:
        want = lag_dot_plain(a, b, halo, L=L)
        got = torch.stack([_lag_dot_schedule(
            a[k], lag_dot_ext(a[k], b[k], halo[k], L=L), L) for k in range(B)])
        for k in range(B):
            torch.testing.assert_close(
                want[k], lag_dot_plain(a[k], b[k], halo[k], L=L), rtol=0,
                atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_resolve_backend(monkeypatch):
    monkeypatch.delenv("CAMEO_BACKEND", raising=False)
    assert t_ops.resolve_backend("auto", "cpu") == "reference"
    assert t_ops.resolve_backend("auto", "cuda") == "cuda"
    assert t_ops.resolve_backend("reference", "cuda") == "reference"
    assert t_ops.resolve_backend("cuda", "cuda") == "cuda"
    with pytest.raises(ValueError):
        t_ops.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError):
        t_ops.resolve_backend("pallas", "cpu")
    monkeypatch.setenv("CAMEO_BACKEND", "reference")
    assert t_ops.resolve_backend("auto", "cuda") == "reference"
    monkeypatch.setenv("CAMEO_BACKEND", "cuda")
    with pytest.raises(ValueError):
        t_ops.resolve_backend("auto", "cpu")
    monkeypatch.setenv("CAMEO_BACKEND", "bogus")
    with pytest.raises(ValueError):
        t_ops.resolve_backend("auto", "cpu")


def test_kernel_eligibility_rule(monkeypatch):
    monkeypatch.delenv("CAMEO_BACKEND", raising=False)
    for measure in ("mae", "rmse", "cheb"):
        assert t_ops._kernel_eligible("auto", "acf", measure, "cuda")
        assert not t_ops._kernel_eligible("auto", "acf", measure, "cpu")
    assert not t_ops._kernel_eligible("auto", "pacf", "mae", "cuda")
    assert not t_ops._kernel_eligible("auto", "acf", "mape", "cuda")
    assert not t_ops._kernel_eligible("reference", "acf", "mae", "cuda")


def test_cuda_backend_with_cpu_tensors_raises():
    with pytest.raises(ValueError):
        t_ops.lag_dot(torch.zeros(16, dtype=torch.float64), 3,
                      backend="cuda")
    cfg = t_cameo.CameoConfig(lags=4, backend="cuda")
    with pytest.raises(ValueError):
        t_cameo.compress(np.zeros(64), cfg, device="cpu")


@pytest.mark.parametrize("kappa", [1, 4])
def test_x_window_to_y(kappa):
    rng = np.random.default_rng(kappa)
    W = 16
    dwin = rng.standard_normal((6, W))
    start = rng.integers(0, 200, 6).astype(np.int32)
    cfg = types.SimpleNamespace(kappa=kappa)   # both read only cfg.kappa
    want = j_ops.x_window_to_y(cfg, jnp.asarray(dwin), jnp.asarray(start))
    got = t_ops.x_window_to_y(cfg, T(dwin), T(start))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_counters_stay_zero_on_cpu():
    from repro_torch.kernels import (acf_impact, dense_sxx, fused_round,
                                     lag_dot)
    wrappers = (lag_dot.lag_dot_cuda, acf_impact.acf_impact_cuda,
                fused_round.window_rows_cuda, dense_sxx.dense_sxx_cuda)
    before = [w.launches for w in wrappers]
    t_cameo.compress(_series(256, np.float64)[0],
                     t_cameo.CameoConfig(eps=0.05, lags=8), device="cpu")
    assert [w.launches for w in wrappers] == before == [0, 0, 0, 0]


def test_import_builds_nothing():
    """Importing the port's kernels compiles, loads and initialises
    nothing CUDA-only."""
    code = (
        "import sys, torch\n"
        "import repro_torch, repro_torch.kernels\n"
        "from repro_torch.kernels import ops, fused_round, lag_dot, "
        "acf_impact, _build\n"
        "from repro_torch.core import cameo\n"
        "assert _build._BUILDER._libs is None\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version, main-path shapes
# ---------------------------------------------------------------------------

def _uk_inputs(device, L=48, n=17520, nb=18432):
    from repro_torch.data.synthetic import make_dataset
    x = np.pad(make_dataset("uk_elec", seed=0, length=n), (0, nb - n))
    y64 = T(x).to(device)
    table = torch.stack(list(t_acf.extract_aggregates_masked(
        T(x), L, n, backend="reference"))).to(device)
    p0 = t_acf.acf_from_aggregates(table, n)
    return x, y64, table, p0, torch.tensor(n, dtype=torch.int32,
                                           device=device)


@pytest.mark.gpu
def test_gpu_lag_dot_one_launch_same_bits(cuda):
    """One call is one launch of the kernel (torch.profiler sees one device
    kernel), and two calls give the same bits."""
    from torch.profiler import ProfilerActivity, profile
    _, y64, *_ = _uk_inputs(cuda)
    first = lag_dot_cuda(y64, L=48)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = lag_dot_cuda(y64, L=48)
        torch.cuda.synchronize()
    assert torch.equal(first, second)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "lag_dot_kernel" in kernels[0], kernels


@pytest.mark.gpu
def test_gpu_lag_dot(cuda):
    """The kernel equals the plain version bit for bit (C12): the self,
    cross and halo forms on uk_elec's row, and the halo form on lanes."""
    _, y64, *_ = _uk_inputs(cuda)
    got = lag_dot_cuda(y64, L=48)
    want = lag_dot_plain(y64, L=48)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    rng = np.random.default_rng(0)
    b, halo = T(rng.standard_normal(18432)).to(cuda), \
        T(rng.standard_normal(48)).to(cuda)
    torch.testing.assert_close(lag_dot_cuda(y64, b, L=48),
                               lag_dot_plain(y64, b, L=48), rtol=0, atol=0)
    torch.testing.assert_close(lag_dot_cuda(y64, b, halo, L=48),
                               lag_dot_plain(y64, b, halo, L=48),
                               rtol=0, atol=0)
    a8 = T(rng.standard_normal((8, 2190))).to(cuda)
    b8 = T(rng.standard_normal((8, 2190))).to(cuda)
    h8 = T(rng.standard_normal((8, 48))).to(cuda)
    got = lag_dot_cuda(a8, b8, h8, L=48)
    torch.testing.assert_close(got, lag_dot_plain(a8, b8, h8, L=48),
                               rtol=0, atol=0)
    for k in range(8):
        assert torch.equal(got[k], lag_dot_cuda(a8[k], b8[k], h8[k], L=48))


@pytest.mark.gpu
@pytest.mark.parametrize("dataset", ["uk_elec", "aus_elec"])
def test_gpu_eq7_tables_at_init_equal_cpu(cuda, dataset):
    """ROADMAP C12: the rounds mode's Eq. 7 table at init on the card (the
    lag_dot and prefix_sum kernels) against the CPU's plain versions: the
    count of differing entries, printed, is 0."""
    from repro_torch.data.synthetic import make_dataset
    L, kappa, n = (48, 1, 17520) if dataset == "uk_elec" else (7, 48, 230688)
    cfg = t_cameo.CameoConfig(eps=1e-2, lags=L, kappa=kappa)
    x = make_dataset(dataset, seed=0, length=n)
    nb = t_cameo._round_bucket(n, cfg)
    xp = T(np.pad(x, (0, nb - n)))[None]
    nv = torch.tensor([n], dtype=torch.int32)
    tables = [t_cameo._rounds_init(xp.to(d), nv.to(d), cfg)[0][5].cpu()
              for d in (cuda, torch.device("cpu"))]
    differ = int(torch.sum(tables[0] != tables[1]))
    print(f"{dataset}: {differ} of {tables[0].numel()} Eq. 7 table "
          f"entries differ")
    assert differ == 0


def _assert_kernel_close(got, want):
    scale = float(torch.max(torch.abs(want)))
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("kappa", [1, 48])
@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
def test_gpu_acf_impact(cuda, kappa, measure):
    _, y64, table, p0, ny = _uk_inputs(cuda)
    rng = np.random.default_rng(1)
    P = y64.shape[0] * kappa
    dval = T(rng.standard_normal(P) * 200.0).float().to(cuda)
    args = (y64.float(), dval, table.float(), p0.float())
    kw = dict(L=48, measure=measure, ny=ny, kappa=kappa)
    torch.testing.assert_close(acf_impact_cuda(*args, **kw),
                               acf_impact_plain(*args, **kw), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kappa", [1, 48])
@pytest.mark.parametrize("L", [7, 32, 33, 48, 257, 365])
def test_gpu_acf_impact_lags(cuda, L, kappa, dtype):
    """Bit for bit equal to the plain version under every measure, with the
    lags spread over lanes (P = 500 or 3,072: up to 256 lanes a candidate,
    several lags a lane past 256) and one lane a candidate (kappa = 48: P =
    147,456 fills the card), on a zero-padded bucket with runtime ny."""
    nyb, ny = 3072, 3000
    rng = np.random.default_rng(L + kappa)
    x = np.zeros(nyb)
    x[:ny] = np.sin(2 * np.pi * np.arange(ny) / 24) \
        + 0.2 * rng.standard_normal(ny)
    table, p0 = _tables(x, L, ny)
    y = T(x).to(cuda, dtype)
    args = [T(table).to(cuda, dtype), T(p0).to(cuda, dtype)]
    ny_t = torch.tensor(ny, dtype=torch.int32, device=cuda)
    for P in (500, nyb * kappa):
        dval = T(rng.standard_normal(P) * 0.05).to(cuda, dtype)
        for measure in ("mae", "rmse", "cheb"):
            kw = dict(L=L, measure=measure, ny=ny_t, kappa=kappa)
            torch.testing.assert_close(
                acf_impact_cuda(y, dval, *args, **kw),
                acf_impact_plain(y, dval, *args, **kw), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("K,Wy", [(768, 8), (384, 64), (10240, 2)])
def test_gpu_window_rows(cuda, K, Wy):
    _, y64, table, _, ny = _uk_inputs(cuda)
    rng = np.random.default_rng(2)
    starts = T(rng.integers(1, 17520 - Wy, K).astype(np.int32)).to(cuda)
    dyws = T(rng.standard_normal((K, Wy)) * 200.0).float().to(cuda)
    p0 = t_acf.acf_from_aggregates(table, 17520).float()
    args = (y64.float(), dyws, starts, table.float(), ny, p0)
    for measure in ("mae", "rmse", "cheb"):
        _assert_kernel_close(
            t_fused.window_rows_cuda(*args, L=48, measure=measure),
            t_fused.window_rows_plain(*args, L=48, measure=measure))
