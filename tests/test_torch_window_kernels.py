"""The Eq. 9 window kernels' schedules (``csrc/acf_window_impact.cu`` and
``csrc/window_rows.cu``) against their plain versions.

The CUDA kernels run only on a card, so their arithmetic is held here
through Python models of their schedules, one rounded operation at a time:
(a) the interior test (``ref.interior_windows``) holds exactly where every
    head and tail mask of the window is 1 (``head_tail_masks`` of the JAX
    package), and for ``window_rows`` exactly where the head cut is the
    whole window and the tail cut empty for every lag;
(b) interior candidates take the fast path (the lag-free sums of d and e,
    then one bilinear chain per lag, then the lags reduced in order) and
    boundary candidates the unchanged masked sums; both models equal the
    plain versions bit for bit, in float32 and float64
    (``acf_window_impact``) and float32 (``window_rows``), under mae, rmse
    and cheb, on boundary-heavy starts;
(c) the plain versions on those starts against the Pallas kernels in
    interpret mode;
plus, on a card only, both kernels against their plain versions at
tolerance 0, at L = 7, 32, 33 and 48 (warp packing and the warp split) and
257 and 365 (past 256 lags a lane takes two; min_temp's L = 365).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.acf import acf_from_aggregates, extract_aggregates
from repro.kernels import fused_round as j_fused
from repro.kernels import ref as j_ref
from repro.kernels.acf_window_impact import acf_window_impact_pallas
from repro_torch.kernels import fused_round as t_fused
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.acf_window_impact import (acf_window_impact_cuda,
                                                   acf_window_impact_plain)

MEASURES = ("mae", "rmse", "cheb")


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


def _setup(ny, L, seed, nyb=None):
    """A zero-padded series of valid length ``ny``, its moment table and
    ACF, float64."""
    rng = np.random.default_rng(seed)
    y = np.zeros(ny if nyb is None else nyb)
    t = np.arange(ny)
    y[:ny] = np.sin(2 * np.pi * t / 24) + 0.2 * rng.standard_normal(ny)
    agg = extract_aggregates(jnp.asarray(y[:ny]), L)
    table = np.stack([np.asarray(a) for a in agg])
    p0 = np.asarray(acf_from_aggregates(agg, ny))
    return y, table, p0, rng


def _edge_starts(rng, ny, W, L, P):
    """Starts within L + W of either end of [0, ny - W], with the four
    starts at the interior test's edges, plus a few interior ones."""
    hi = ny - W
    near = np.concatenate([rng.integers(0, L + W, P // 2),
                           rng.integers(max(0, hi - L - W), hi + 1, P // 2)])
    edges = [L - 1, L, ny - L - W, ny - L - W + 1]
    mid = rng.integers(L, ny - L - W + 1, 6)
    return np.clip(np.concatenate([near, edges, mid]), 0, hi).astype(np.int32)


def _reduce(terms, measure, L):
    """The kernels' reduction: lag terms in order from 0 (rn::measure_step),
    then rn::measure_final."""
    acc = torch.zeros((), dtype=terms.dtype)
    for t in terms:
        if measure == "cheb":
            acc = acc if bool(acc > t) else t
        else:
            acc = acc + t
    if measure == "cheb":
        return acc
    acc = acc / torch.full((), L, dtype=terms.dtype)
    return t_ref.sqrt_rn(acc) if measure == "rmse" else acc


def _chain(terms, start=None):
    """Sum over the last axis first to last, from ``start`` (default: the
    first term, as rn::window_sums starts)."""
    acc = terms[..., 0] if start is None else start + terms[..., 0]
    for j in range(1, terms.shape[-1]):
        acc = acc + terms[..., j]
    return acc


def _finish(sums, table, p0, m, measure, L):
    rho = t_ref.acf_from_table(table + sums, m)
    diff = rho - p0
    return _reduce(diff * diff if measure == "rmse" else torch.abs(diff),
                   measure, L)


def _awi_schedule(ctx, dwins, starts, table, p0, *, ny, L, measure,
                  fast=True):
    """``acf_window_impact.cu``'s schedule: e formed where d is staged; an
    interior candidate (``fast``) forms sum d and sum e once and one
    bilinear chain per lag; a boundary one the five masked sums of
    ``rn::window_sums``, every head/tail product rounded; the lags reduced
    in order."""
    P, W = dwins.shape
    dt = dwins.dtype
    l = torch.arange(1, L + 1)
    m = (ny - l).to(dt)
    interior = t_ref.interior_windows(starts, W, L, ny)
    out = []
    for p in range(P):
        s, d, c = int(starts[p]), dwins[p], ctx[p]
        e = d * (2.0 * c[L:L + W] + d)
        d_pad = F.pad(d, (0, L))
        if fast and bool(interior[p]):
            sd, se = _chain(d), _chain(e)
            prod = torch.stack([d * ((c[L + lag:L + lag + W]
                                      + c[L - lag:L - lag + W])
                                     + d_pad[lag:lag + W])
                                for lag in range(1, L + 1)])      # [L, W]
            sums = torch.stack([sd.expand(L), sd.expand(L), se.expand(L),
                                se.expand(L), _chain(prod)])
        else:
            cols = []
            for j in range(W):
                h = (s + j <= ny - 1 - l).to(dt)
                tl = (s + j >= l).to(dt)
                inner = (c[L + j + l] * h + c[L + j - l] * tl) \
                    + d_pad[j + l] * h
                cols.append(torch.stack([d[j] * h, d[j] * tl, e[j] * h,
                                         e[j] * tl, d[j] * inner]))
            sums = _chain(torch.stack(cols, dim=-1))
        out.append(_finish(sums, table, p0, m, measure, L))
    return torch.stack(out)


def _rows_schedule(y, dyws, ystarts, table, ny, p0, *, L, measure,
                   fast=True):
    """``window_rows.cu``'s schedule, float32: the context at the clipped
    start; an interior candidate (``fast``) takes the prefix sums cd, ce
    whole (from 0) beside one bilinear chain per lag (from 0), a boundary
    one the walk with the head/tail cuts ch, ct of every lag; the lags
    reduced in order."""
    K, Wy = dyws.shape
    dt = y.dtype
    ny = int(ny)
    l = torch.arange(1, L + 1)
    m = (ny - l).to(dt)
    ctx = t_fused.candidate_context(y, ystarts, L=L, Wy=Wy)
    interior = t_ref.interior_windows(ystarts, Wy, L, ny)
    zero = torch.zeros((), dtype=dt)
    out = []
    for k in range(K):
        ys, d, c = int(ystarts[k]), dyws[k], ctx[k]
        e = d * (2.0 * c[L:L + Wy] + d)
        d_pad = F.pad(d, (0, L))
        prod = torch.stack([d * ((c[L + lag:L + lag + Wy]
                                  + c[L - lag:L - lag + Wy])
                                 + d_pad[lag:lag + Wy])
                            for lag in range(1, L + 1)])          # [L, Wy]
        dsxx = _chain(prod, zero)
        if fast and bool(interior[k]):
            cd, ce = _chain(d, zero), _chain(e, zero)
            sums = torch.stack([cd.expand(L), cd.expand(L), ce.expand(L),
                                ce.expand(L), dsxx])
        else:
            cdz = [zero]
            cez = [zero]
            for j in range(Wy):
                cdz.append(cdz[-1] + d[j])
                cez.append(cez[-1] + e[j])
            rows = []
            for lag in range(1, L + 1):
                ch = min(max(ny - lag - ys, 0), Wy)
                ct = min(max(lag - ys, 0), Wy)
                rows.append(torch.stack([cdz[ch], cdz[Wy] - cdz[ct], cez[ch],
                                         cez[Wy] - cez[ct]]))
            sums = torch.cat([torch.stack(rows, dim=1), dsxx[None]])
        out.append(_finish(sums, table, p0, m, measure, L))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# (a) the interior test
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kappa,L,W,ny", [(1, 48, 64, 600), (48, 7, 3, 100)])
def test_interior_test_is_all_masks_one(kappa, L, W, ny):
    """kappa 1: uk_elec's L and window; kappa 48: aus_elec's L and Wy =
    W // kappa + 2, on y."""
    rng = np.random.default_rng(kappa)
    starts = np.unique(np.concatenate([
        rng.integers(0, ny - W + 1, 300),
        [0, L - 1, L, ny - L - W, ny - L - W + 1, ny - W]])).astype(np.int32)
    got = t_ref.interior_windows(T(starts), W, L, ny).numpy()
    abs_t = jnp.asarray(starts)[:, None] + jnp.arange(W)[None, :]
    head, tail = j_ref.head_tail_masks(abs_t, ny, L, jnp.float64)
    want = np.asarray(jnp.all((head == 1) & (tail == 1), axis=(1, 2)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and (~got).any()
    assert not got[starts == L - 1].any() and got[starts == L].all()
    assert got[starts == ny - L - W].all()
    assert not got[starts == ny - L - W + 1].any()
    # window_rows' form: the head cut is the whole window and the tail cut
    # empty for every lag
    lag = np.arange(1, L + 1)
    ch = np.clip(ny - lag[None, :] - starts[:, None], 0, W)
    ct = np.clip(lag[None, :] - starts[:, None], 0, W)
    np.testing.assert_array_equal(
        got, np.all((ch == W) & (ct == 0), axis=1))


# ---------------------------------------------------------------------------
# (b) the schedules against the plain versions, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("L,W", [(7, 3), (12, 16), (40, 16)])
def test_acf_window_impact_schedule_exact(L, W, measure, dtype):
    ny = 160
    y, table, p0, rng = _setup(ny, L, seed=5)
    starts = _edge_starts(rng, ny, W, L, 24)
    dwins = 0.1 * rng.standard_normal((starts.shape[0], W))
    st = T(starts)
    ctx = t_ref.candidate_contexts(T(y).to(dtype), st, L=L, W=W)
    args = (ctx, T(dwins).to(dtype), st, T(table).to(dtype), T(p0).to(dtype))
    kw = dict(ny=ny, L=L, measure=measure)
    want = acf_window_impact_plain(*args, **kw)
    interior = t_ref.interior_windows(st, W, L, ny)
    assert interior.any() and (~interior).any()
    for fast in (True, False):
        torch.testing.assert_close(_awi_schedule(*args, fast=fast, **kw),
                                   want, rtol=0, atol=0)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("L,Wy", [(7, 3), (12, 16)])
def test_window_rows_schedule_exact(L, Wy, measure):
    ny, nyb = 150, 160
    y, table, p0, rng = _setup(ny, L, seed=6, nyb=nyb)
    starts = _edge_starts(rng, ny, Wy, L, 24)
    dyws = 0.1 * rng.standard_normal((starts.shape[0], Wy))
    st = T(starts)
    args = (T(y).float(), T(dyws).float(), st, T(table).float(),
            torch.tensor(ny, dtype=torch.int32), T(p0).float())
    want = t_fused.window_rows_plain(*args, L=L, measure=measure)
    interior = t_ref.interior_windows(st, Wy, L, ny)
    assert interior.any() and (~interior).any()
    for fast in (True, False):
        torch.testing.assert_close(
            _rows_schedule(*args, L=L, measure=measure, fast=fast), want,
            rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (c) the plain versions on boundary-heavy starts against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
def test_window_plain_versions_match_pallas_at_edges(measure):
    L, W, ny, nyb = 8, 12, 140, 160
    y, table, p0, rng = _setup(ny, L, seed=8, nyb=nyb)
    starts = _edge_starts(rng, ny, W, L, 20)
    dwins = 0.1 * rng.standard_normal((starts.shape[0], W))
    ctx = j_ref.candidate_contexts(jnp.asarray(y[:ny]), jnp.asarray(starts),
                                   L=L, W=W)
    want = np.asarray(acf_window_impact_pallas(
        ctx, jnp.asarray(dwins), jnp.asarray(starts), jnp.asarray(table),
        jnp.asarray(p0), ny=ny, L=L, measure=measure, block=128,
        interpret=True))
    got = acf_window_impact_plain(
        t_ref.candidate_contexts(T(y[:ny]), T(starts), L=L, W=W), T(dwins),
        T(starts), T(table), T(p0), ny=ny, L=L, measure=measure)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    # window_rows, float32: the Pallas rows reduced by measure_rows
    y32, d32 = y.astype(np.float32), dwins.astype(np.float32)
    t32, p32 = table.astype(np.float32), p0.astype(np.float32)
    rows = j_fused.window_rows_pallas(
        jnp.asarray(y32), jnp.asarray(d32), jnp.asarray(starts),
        jnp.asarray(t32), ny, L=L, interpret=True)
    got = t_fused.window_rows_plain(
        T(y32), T(d32), T(starts), T(t32),
        torch.tensor(ny, dtype=torch.int32), T(p32), L=L, measure=measure)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_ref.measure_rows(rows, p32, measure)),
        rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card: both kernels at tolerance 0
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [7, 32, 33, 48, 257, 365])
@pytest.mark.parametrize("W,P", [(3, 1000), (64, 50), (64, 700)])
def test_gpu_acf_window_impact_exact(cuda, L, W, P):
    ny = 3000
    y, table, p0, rng = _setup(ny, L, seed=L + W)
    starts = T(_edge_starts(rng, ny, W, L, P)).to(cuda)
    dwins = rng.standard_normal((starts.shape[0], W)) * 0.05
    for dt in (torch.float64, torch.float32):
        ctx = t_ref.candidate_contexts(T(y).to(dt).to(cuda), starts, L=L,
                                       W=W)
        args = (ctx, T(dwins).to(dt).to(cuda), starts,
                T(table).to(dt).to(cuda), T(p0).to(dt).to(cuda))
        for measure in MEASURES:
            kw = dict(ny=ny, L=L, measure=measure)
            torch.testing.assert_close(acf_window_impact_cuda(*args, **kw),
                                       acf_window_impact_plain(*args, **kw),
                                       rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [7, 32, 33, 48, 257, 365])
@pytest.mark.parametrize("Wy,K", [(2, 10240), (3, 700), (64, 384)])
def test_gpu_window_rows_exact(cuda, L, Wy, K):
    ny, nyb = 3000, 3072
    y, table, p0, rng = _setup(ny, L, seed=L + Wy, nyb=nyb)
    starts = T(_edge_starts(rng, ny, Wy, L, K)).to(cuda)
    dyws = T(rng.standard_normal((starts.shape[0], Wy)) * 0.05).float()
    args = (T(y).float().to(cuda), dyws.to(cuda), starts,
            T(table).float().to(cuda),
            torch.tensor(ny, dtype=torch.int32, device=cuda),
            T(p0).float().to(cuda))
    for measure in MEASURES:
        torch.testing.assert_close(
            t_fused.window_rows_cuda(*args, L=L, measure=measure),
            t_fused.window_rows_plain(*args, L=L, measure=measure),
            rtol=0, atol=0)
