"""The port's sequential mode (paper Algorithm 1) and its windowed-impact
kernel against the JAX package.

(a) ``acf_window_impact_plain`` (the CUDA kernel's plain version) against
    ``acf_window_impact_pallas`` in interpret mode and against
    ``ref.acf_window_impact_ref``, on ``test_acf_window_impact_kernel_sweep``'s
    sweep, float64, to 1e-10 (``tests/test_kernels.py``'s tolerance);
(b) the float64 form of ``acf_impact`` (the sequential init) against the
    Pallas kernel;
(c) ``apply_delta_window``, ``ranking_impact`` (both ranks, kappa 1 and 4),
    ``chunk_ranking_impact``, ``window_impact`` and ``window_impact_at``
    against JAX, and the ReHeap neighbour walk against a transcription of
    the JAX loop;
(d) ``compress(mode="sequential")`` against ``compress_sequential`` end to
    end: kept masks and ``iters`` identical, deviation within 1e-12;
(e) the carry crossing packages mid-run (``convert``);
plus, on a card only, the kernel against its plain version and the mode
on the card.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregates as j_agg
from repro.core import cameo as jc
from repro.core.acf import acf_from_aggregates, extract_aggregates
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.acf_impact import acf_impact_pallas
from repro.kernels.acf_window_impact import acf_window_impact_pallas
from repro_torch import convert
from repro_torch.core import aggregates as t_agg
from repro_torch.core import cameo as tc
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.acf_impact import acf_impact_cuda, acf_impact_plain
from repro_torch.kernels.acf_window_impact import (acf_window_impact_cuda,
                                                   acf_window_impact_plain)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)          # chip_smoke.py, at the repository root


def T(a):
    return torch.from_numpy(np.array(a))


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (np.sin(2 * np.pi * t / 24) + 0.5 * np.sin(2 * np.pi * t / 168)
            + 0.15 * rng.standard_normal(n))


def _setup(n, L, seed):
    """``tests/test_kernels.py``'s ``_setup`` in float64."""
    rng = np.random.default_rng(seed)
    y = np.sin(2 * np.pi * np.arange(n) / 24) + 0.2 * rng.standard_normal(n)
    agg = extract_aggregates(jnp.asarray(y), L)
    tab = np.asarray(j_ops.agg_to_table(agg))
    p0 = np.asarray(acf_from_aggregates(agg, n))
    return y, tab, p0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a), (b) the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
@pytest.mark.parametrize("n,L,W,block", [
    (512, 12, 16, 128), (1000, 24, 64, 256), (513, 7, 32, 128)])
def test_acf_window_impact_plain_matches_pallas(n, L, W, block, measure):
    rng = np.random.default_rng(7)
    y, tab, p0 = _setup(n, L, seed=7)
    P = 200
    starts = rng.integers(0, n - 1, P).astype(np.int32)
    spans = rng.integers(1, W + 1, P)
    dwins = rng.standard_normal((P, W)) * 0.1
    dwins = dwins * (np.arange(W)[None, :] < spans[:, None])
    ctx = j_ref.candidate_contexts(jnp.asarray(y), jnp.asarray(starts), L=L,
                                   W=W)
    want = np.asarray(acf_window_impact_pallas(
        ctx, jnp.asarray(dwins), jnp.asarray(starts), jnp.asarray(tab),
        jnp.asarray(p0), ny=n, L=L, measure=measure, block=block,
        interpret=True))
    want_ref = np.asarray(j_ref.acf_window_impact_ref(
        ctx, jnp.asarray(dwins), jnp.asarray(starts), jnp.asarray(tab),
        jnp.asarray(p0), ny=n, measure=measure))
    t_ctx = t_ref.candidate_contexts(T(y), T(starts), L=L, W=W)
    np.testing.assert_array_equal(t_ctx.numpy(), np.asarray(ctx))
    args = (t_ctx, T(dwins), T(starts), T(tab), T(p0))
    got = acf_window_impact_plain(*args, ny=n, L=L, measure=measure)
    # CPU tensors: the wrapper is the plain version
    torch.testing.assert_close(
        acf_window_impact_cuda(*args, ny=n, L=L, measure=measure), got,
        rtol=0, atol=0)
    for w in (want, want_ref):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-10, atol=1e-10)
    # the backend dispatch computes the same from the series and starts
    for backend in ("auto", "reference"):
        np.testing.assert_array_equal(t_ops.window_impact(
            T(y), T(dwins), T(starts), T(tab), T(p0), measure=measure,
            backend=backend).numpy(), got.numpy())


def test_window_impact_matches_recompute():
    """Windowed impacts equal brute-force from-scratch deviations (the
    oracle of ``tests/test_kernels.py``)."""
    from repro_torch.core.acf import acf
    n, L, W = 256, 8, 16
    y, tab, p0 = _setup(n, L, seed=5)
    starts = np.array([0, 100, 200, 250], np.int32)
    rng = np.random.default_rng(5)
    dwins = 0.3 * rng.standard_normal((4, W))
    for p, s in enumerate(starts):
        dwins[p, max(0, n - s):] = 0.0
    got = t_ops.window_impact(T(y), T(dwins), T(starts), T(tab), T(p0))
    for p, s in enumerate(starts):
        dense = np.zeros(n)
        dense[s:s + W] = dwins[p, :n - s]
        want = float(torch.mean(torch.abs(acf(T(y + dense), L) - T(p0))))
        assert abs(float(got[p]) - want) < 1e-9


@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
@pytest.mark.parametrize("kappa", [1, 4])
def test_acf_impact_float64_matches_pallas(kappa, measure):
    """The float64 form of the Eq. 8 kernel (the sequential init) against
    the Pallas kernel at float64, kappa as the init applies it."""
    n, L = 1000, 24
    y, tab, p0 = _setup(n // kappa, L, seed=3)
    rng = np.random.default_rng(3)
    dval = 0.1 * rng.standard_normal(n)
    if kappa == 1:
        want = np.asarray(acf_impact_pallas(
            jnp.asarray(y), jnp.asarray(dval), jnp.asarray(tab),
            jnp.asarray(p0), L=L, measure=measure, block=256,
            interpret=True))
    else:
        want = np.stack([np.asarray(acf_impact_pallas(
            jnp.asarray(y), jnp.asarray(dval.reshape(-1, kappa)[:, r]),
            jnp.asarray(tab), jnp.asarray(p0), L=L, measure=measure,
            block=256, interpret=True)) for r in range(kappa)],
            axis=-1).reshape(n)
    got = acf_impact_cuda(T(y), T(dval), T(tab), T(p0), L=L,
                          measure=measure, kappa=kappa)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, acf_impact_plain(
        T(y), T(dval), T(tab), T(p0), L=L, measure=measure, kappa=kappa),
        rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# (c) the sequential mode's building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 3, 90, 120, 125])
@pytest.mark.parametrize("L", [1, 5, 12])
def test_apply_delta_window_matches_jax(start, L):
    rng = np.random.default_rng(start + 10 * L)
    ny, W = 128, 8
    y = rng.standard_normal(ny)
    dw = 0.2 * rng.standard_normal(W)
    dw[max(0, ny - start):] = 0.0
    agg = extract_aggregates(jnp.asarray(y), L)
    want = j_agg.apply_delta_window(agg, jnp.asarray(y), jnp.asarray(dw),
                                    jnp.asarray(start, jnp.int32), W=W, L=L)
    tab = T(np.stack([np.asarray(a) for a in agg]))
    for start_arg in (start, torch.tensor(start, dtype=torch.int32)):
        got = t_agg.apply_delta_window(tab, T(y), T(dw), start_arg, W=W, L=L)
        np.testing.assert_allclose(got.numpy(), np.stack(
            [np.asarray(a) for a in want]), rtol=1e-12, atol=1e-12)
    # the tuple form comes back as a tuple, and equals a from-scratch table
    got_t = t_agg.apply_delta_window(
        t_agg.Aggregates(*tab), T(y), T(dw), start, W=W, L=L)
    assert isinstance(got_t, t_agg.Aggregates)
    dense = y.copy()
    dense[start:start + W] += dw[:ny - start]
    fresh = extract_aggregates(jnp.asarray(dense), L)
    for a, b in zip(got_t, fresh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-9)


def _alive(n, seed, frac=0.6):
    rng = np.random.default_rng(seed)
    alive = rng.random(n) > frac
    alive[0] = alive[-1] = True
    return alive


@pytest.mark.parametrize("measure", ["mae", "cheb"])
@pytest.mark.parametrize("rank", ["window", "single"])
@pytest.mark.parametrize("kappa", [1, 4])
def test_ranking_impact_matches_jax(rank, kappa, measure):
    n, L = 384, 8
    x = _series(n, 3)
    alive = _alive(n, kappa)
    jcfg = jc.CameoConfig(lags=L, kappa=kappa, window=16, measure=measure,
                          impact_chunk=100, backend="reference")
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    xr = np.asarray(jc._reconstruct(jnp.asarray(x), jnp.asarray(alive)))
    y = np.asarray(jc.aggregate_series(jnp.asarray(xr), kappa))
    agg = extract_aggregates(jnp.asarray(y), L)
    tab = np.stack([np.asarray(a) for a in agg])
    p0 = np.asarray(acf_from_aggregates(extract_aggregates(
        jc.aggregate_series(jnp.asarray(x), kappa), L), n // kappa))
    want = np.asarray(j_ops.ranking_impact(
        jcfg, agg, jnp.asarray(y), jnp.asarray(xr), jnp.asarray(alive),
        jnp.asarray(p0), n, rank=rank))
    got = t_ops.ranking_impact(tcfg, T(tab), T(y), T(xr), T(alive), T(p0),
                               n, rank=rank).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.sum() > 10
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=1e-12)
    if rank == "window":
        # the partitioned form: a chunk with halo context and global offset
        off, m = 64 // kappa, 160
        xs = slice(off * kappa, off * kappa + m)
        y_ctx = np.pad(y, (L, L + 16))[off:off + m // kappa + 2 * L + 16]
        jw = np.asarray(j_ops.chunk_ranking_impact(
            jcfg, agg, jnp.asarray(y_ctx), jnp.asarray(xr[xs]),
            jnp.asarray(alive[xs]), jnp.asarray(p0), off, n // kappa))
        tw = t_ops.chunk_ranking_impact(
            tcfg, T(tab), T(y_ctx), T(xr[xs]), T(alive[xs]), T(p0), off,
            n // kappa).numpy()
        np.testing.assert_array_equal(np.isinf(tw), np.isinf(jw))
        fin = np.isfinite(jw)
        np.testing.assert_allclose(tw[fin], jw[fin], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kappa", [1, 4])
def test_window_impact_at_matches_jax(kappa):
    n, L = 256, 6
    x = _series(n, 8)
    alive = _alive(n, 8 + kappa)
    alive[100:180] = False              # one segment wider than W = 64
    jcfg = jc.CameoConfig(lags=L, kappa=kappa, backend="reference")
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    xr = np.asarray(jc._reconstruct(jnp.asarray(x), jnp.asarray(alive)))
    prev, nxt = (np.asarray(a) for a in j_agg.alive_neighbors(
        jnp.asarray(alive)))
    y = np.asarray(jc.aggregate_series(jnp.asarray(xr), kappa))
    agg = extract_aggregates(jnp.asarray(y), L)
    p0 = np.asarray(acf_from_aggregates(agg, n // kappa))
    cand = np.array([0, 1, 2, 50, 99, 120, 181, 200, 254, 255, 255, 0],
                    np.int32)
    want = np.asarray(j_ops.window_impact_at(
        jcfg, agg, jnp.asarray(y), jnp.asarray(xr), jnp.asarray(prev),
        jnp.asarray(nxt), jnp.asarray(cand), jnp.asarray(p0)))
    got = t_ops.window_impact_at(
        tcfg, T(np.stack([np.asarray(a) for a in agg])), T(y), T(xr), T(prev),
        T(nxt), T(cand), T(p0)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(want[[0, 5, 9, 10, 11]]).all()  # endpoints, overgrown
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=1e-12)


def _walk(prev, nxt, p, q, h):
    """``compress_sequential``'s ``collect_neighbors`` pointer walk
    (``src/repro/core/cameo.py:805-826``), transcribed."""
    n = prev.shape[0]
    left, ptr = [], int(np.clip(p, 0, n - 1))
    for _ in range(h + 1):
        left.append(ptr)
        ptr = int(np.clip(prev[np.clip(ptr, 0, n - 1)], -1, n - 1))
        ptr = 0 if ptr < 0 else ptr
    right, ptr = [], int(np.clip(q, 0, n - 1))
    for _ in range(h + 1):
        right.append(ptr)
        ptr = int(np.clip(nxt[np.clip(ptr, 0, n - 1)], 0, n))
        ptr = n - 1 if ptr >= n else ptr
    return np.array(left + right)


@pytest.mark.parametrize("seed", range(6))
def test_collect_neighbors_matches_pointer_walk(seed):
    rng = np.random.default_rng(seed)
    n, h = 90, int(rng.integers(1, 30))
    alive = _alive(n, seed, frac=rng.random())
    prev, nxt = (np.asarray(a) for a in j_agg.alive_neighbors(
        jnp.asarray(alive)))
    for i in rng.choice(np.nonzero(alive[1:-1])[0] + 1, 5):
        # remove i as the sequential body does, then walk from p and q
        p, q = prev[i], nxt[i]
        alive2 = alive.copy()
        alive2[i] = False
        prev2, nxt2 = prev.copy(), nxt.copy()
        prev2[q], nxt2[p] = p, q
        want = _walk(prev2, nxt2, p, q, h)
        got = tc._collect_neighbors(T(alive2), torch.tensor(p),
                                    torch.tensor(q), h)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (d) end to end
# ---------------------------------------------------------------------------

SEQ_CASES = {
    "k1": dict(), "k4": dict(kappa=4), "rmse": dict(measure="rmse"),
    "cheb": dict(measure="cheb"), "pacf": dict(stat="pacf"),
    "target_cr": dict(target_cr=5.0),
    "first_violation": dict(stop_policy="first_violation"),
    "single-hop": dict(hops=1, window=16),
}


def _seq_cfg(name):
    return jc.CameoConfig(eps=0.05, lags=8, mode="sequential",
                          backend="reference", **SEQ_CASES[name])


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_sequential_end_to_end(name):
    import chip_smoke
    x = _series(384, seed=5)
    jcfg = _seq_cfg(name)
    want = jc.compress(jnp.asarray(x), jcfg)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    got = tc.compress(x, tcfg, device="cpu")
    np.testing.assert_array_equal(got.kept.numpy(), np.asarray(want.kept))
    assert int(got.iters) == int(want.iters)
    assert abs(float(got.deviation) - float(want.deviation)) <= 1e-12
    np.testing.assert_allclose(got.xr.numpy(), np.asarray(want.xr),
                               rtol=0, atol=1e-12)
    kept, xr = got.kept.numpy(), got.xr.numpy()
    assert kept[0] and kept[-1]
    np.testing.assert_array_equal(xr[kept], x[kept])
    if tcfg.target_cr is None:
        assert float(got.deviation) <= tcfg.eps
    assert abs(chip_smoke.remeasure(x, xr, tcfg)
               - float(got.deviation)) <= 1e-9


# ---------------------------------------------------------------------------
# (e) the carry across packages
# ---------------------------------------------------------------------------

def test_sequential_carry_resumes_across_packages():
    """After k pops the port's carry holds the reference's state (JAX run
    with max_iters = k); through numpy and back it resumes to the
    reference's full run."""
    x = _series(384, seed=5)
    jcfg = _seq_cfg("k1")
    k = 150
    part = jc.compress(jnp.asarray(x), dataclasses.replace(jcfg, max_iters=k))
    full = jc.compress(jnp.asarray(x), jcfg)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    xt = T(x)
    carry, p0 = tc._sequential_init(xt, tcfg)
    probe, body = tc._sequential_fns(tcfg, 384, p0)
    for _ in range(k):
        carry = body(carry)
    arrays = convert.sequential_carry_to_numpy(carry)
    assert [a.dtype for a in arrays] == [
        np.float64, np.bool_, np.int32, np.int32, np.float64, np.float64,
        np.float64, np.float64, np.int32, np.bool_]
    assert arrays[5].shape == (5, 8)
    np.testing.assert_array_equal(arrays[1], np.asarray(part.kept))
    np.testing.assert_allclose(arrays[0], np.asarray(part.xr), rtol=0,
                               atol=1e-12)
    assert int(arrays[8]) == int(part.iters) == k
    assert abs(float(arrays[7]) - float(part.deviation)) <= 1e-12
    # agg may cross as JAX's five rows as well as the table
    for agg in (arrays[5], tuple(arrays[5])):
        back = convert.sequential_carry_from_numpy(
            arrays[:5] + (agg,) + arrays[6:], "cpu")
        for a, b in zip(back, carry):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    carry = tc._run_sequential(back, probe, body, block=7)
    np.testing.assert_array_equal(carry[1].numpy(), np.asarray(full.kept))
    assert int(carry[8]) == int(full.iters)
    with pytest.raises(ValueError):
        convert.sequential_carry_from_numpy(arrays[:9], "cpu")


def test_sequential_steps_past_the_end_are_no_ops():
    x = _series(200, seed=2)
    tcfg = convert.config_from_dict(dataclasses.asdict(
        dataclasses.replace(_seq_cfg("k1"), max_iters=40)))
    carry, p0 = tc._sequential_init(T(x), tcfg)
    probe, body = tc._sequential_fns(tcfg, 200, p0)
    end = tc._run_sequential(carry, probe, body, block=1)
    more = end
    for _ in range(5):
        more = body(more)
    for a, b in zip(end, more):
        assert torch.equal(a, b)
    assert int(end[8]) == 40


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("P,W,L", [(50, 64, 48), (4096, 64, 48), (50, 3, 7)])
def test_gpu_acf_window_impact(cuda, P, W, L):
    n = 17520
    y, tab, p0 = _setup(n, L, seed=1)
    rng = np.random.default_rng(2)
    starts = T(rng.integers(0, n - W, P).astype(np.int32)).to(cuda)
    dwins = T(0.05 * rng.standard_normal((P, W))).to(cuda)
    ctx = t_ref.candidate_contexts(T(y).to(cuda), starts, L=L, W=W)
    args = (ctx, dwins, starts, T(tab).to(cuda), T(p0).to(cuda))
    for measure in ("mae", "rmse", "cheb"):
        got = acf_window_impact_cuda(*args, ny=n, L=L, measure=measure)
        want = acf_window_impact_plain(*args, ny=n, L=L, measure=measure)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


@pytest.mark.gpu
def test_gpu_sequential(cuda):
    from repro_torch.data.synthetic import make_dataset
    x = make_dataset("uk_elec", seed=0, length=1024)
    cfg = tc.CameoConfig(eps=1e-2, lags=48, mode="sequential", hops=24)
    before = acf_window_impact_cuda.launches, acf_impact_cuda.launches
    res = tc.compress(x, cfg)
    assert acf_window_impact_cuda.launches > before[0]
    assert acf_impact_cuda.launches > before[1]
    cpu = tc.compress(x, cfg, device="cpu")
    assert float(res.deviation) <= cfg.eps
    cr, cr_cpu = 1024 / float(res.n_kept), 1024 / float(cpu.n_kept)
    assert abs(cr - cr_cpu) <= 0.05 * cr_cpu
