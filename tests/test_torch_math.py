"""The port's series math (``repro_torch.kernels.ref``, ``core.measures``,
``core.acf``, ``core.aggregates``) against its ``repro`` counterparts.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: integers exact; float64 1e-10; float32 3e-5 (the two
frameworks sum in different orders).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import hypothesis_or_stubs

from repro.core import acf as j_acf
from repro.core import aggregates as j_agg
from repro.core import measures as j_meas
from repro.kernels import ref as j_ref
from repro_torch.core import acf as t_acf
from repro_torch.core import aggregates as t_agg
from repro_torch.core import measures as t_meas
from repro_torch.kernels import ref as t_ref

given, settings, st = hypothesis_or_stubs()

TOL = {np.float64: 1e-10, np.float32: 3e-5}
_SEED = st.integers(0, 10_000)
_L = st.sampled_from([1, 4, 12])
_KAPPA = st.sampled_from([1, 4])


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, dtype=np.float64):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def target(seed, n, kappa, pad=True):
    """A zero-padded Def. 2 target series and its valid length."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * kappa)
    x = (np.sin(2 * np.pi * t / 24) + 0.5 * np.sin(2 * np.pi * t / 7)
         + 0.2 * rng.standard_normal(n * kappa))
    y = x.reshape(n, kappa).mean(axis=1)
    return (np.pad(y, (0, int(rng.integers(1, 17)))) if pad else y), n, rng


# JAX references, jitted once per shape (eager JAX compiles every primitive)
_j_single = jax.jit(lambda agg, y, idx, dval, ny: j_ref.acf_after_single_delta(
    agg, y, idx, dval, ny=ny))
_j_dense_ref = jax.jit(lambda agg, y, d, ny: jnp.stack(list(
    j_agg.apply_delta_dense_ref(agg, y, d, ny=ny))))
_j_masked = jax.jit(j_acf.extract_aggregates_masked, static_argnums=(1,))
_j_pacf = jax.jit(j_acf.pacf_from_acf)
_j_pacf_rows = jax.jit(jax.vmap(j_acf.pacf_from_acf))


@functools.partial(jax.jit, static_argnums=(4,))
def _j_geometry(x, alive, cand, removed, W):
    prev, nxt = j_agg.alive_neighbors(alive)
    idx = jnp.arange(x.shape[0], dtype=jnp.int32)
    interp = j_agg.interpolate_at(x, prev, nxt, idx)
    seg = j_agg.segment_interp(x, prev, nxt, cand, W)
    dlt = j_agg.segment_deltas(x, prev, nxt, cand, W)
    after = j_agg.neighbors_after_removal(prev, nxt, removed)
    return prev, nxt, interp, seg, dlt, after


def alive_mask(rng, n, p=0.35):
    alive = rng.random(n) > p
    alive[0] = alive[-1] = True
    return alive


# ---------------------------------------------------------------------------
# kernels/ref.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ref_moment_forms(dtype):
    rng = np.random.default_rng(0)
    P, L, ny = 40, 12, 300
    moments = [rng.standard_normal((P, L)).astype(dtype) * s
               for s in (10, 10, 100, 100, 50)]
    moments[2] = np.abs(moments[2]) + 400
    moments[3] = np.abs(moments[3]) + 400
    m = (ny - np.arange(1, L + 1)).astype(dtype)[None, :]
    close(t_ref.acf_from_moments(*map(T, moments), T(m)),
          jax.jit(j_ref.acf_from_moments)(*moments, m), dtype)
    rows = np.stack(moments, axis=1)                        # [P, 5, L]
    close(t_ref.acf_from_table(T(rows), T(m)),
          jax.jit(j_ref.acf_from_table)(rows, m), dtype)
    idx = rng.integers(0, ny, 50).astype(np.int32)
    for got, want in zip(t_ref.head_tail_masks(T(idx), ny, L, torch.float64),
                         j_ref.head_tail_masks(jnp.asarray(idx), ny, L,
                                               jnp.float64)):
        exact(got, want)
    r = rng.standard_normal((P, L)).astype(dtype)
    p0 = rng.standard_normal(L).astype(dtype)
    j_rows = jax.jit(j_ref.measure_rows, static_argnums=(2,))
    for measure in t_ref.KERNEL_MEASURES:
        close(t_ref.measure_rows(T(r), T(p0), measure),
              j_rows(r, p0, measure), dtype)
    table = rng.standard_normal((5, L))
    exact(t_ref.as_table([T(row) for row in table]), table)


def _single_delta_case(seed, n, L, kappa, dtype):
    y, ny, rng = target(seed, n, 1)
    y = y.astype(dtype)
    agg = np.stack(list(j_acf.extract_aggregates(jnp.asarray(y[:ny]), L)))
    P = y.shape[0] * kappa
    idx = (np.arange(P) // kappa).astype(np.int32)
    dval = (0.1 * rng.standard_normal(P)).astype(dtype)
    want = _j_single(agg.astype(dtype), y, idx, dval,
                     jnp.asarray(ny, jnp.int32))
    got = t_ref.acf_after_single_delta(
        T(agg.astype(dtype)), T(y), T(idx), T(dval),
        ny=torch.tensor(ny, dtype=torch.int32))
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kappa", [1, 4])
def test_acf_after_single_delta_runtime_ny(dtype, kappa):
    _single_delta_case(11, 200, 12, kappa, dtype)


@settings(max_examples=10, deadline=None)
@given(_SEED, _L, _KAPPA)
def test_acf_after_single_delta_hypothesis(seed, L, kappa):
    _single_delta_case(seed, 96, L, kappa, np.float64)


@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
def test_acf_impact_ref(measure):
    y, ny, rng = target(3, 300, 1, pad=False)
    agg = np.stack(list(j_acf.extract_aggregates(jnp.asarray(y), 12)))
    p0 = np.asarray(j_acf.acf_from_aggregates(agg, ny))
    dval = 0.1 * rng.standard_normal(ny)
    close(t_ref.acf_impact_ref(T(y), T(dval), T(agg), T(p0), L=12,
                               measure=measure),
          j_ref.acf_impact_ref(jnp.asarray(y), jnp.asarray(dval), agg, p0,
                               L=12, measure=measure))


@settings(max_examples=15, deadline=None)
@given(_SEED, _L)
def test_lag_xdot_forms(seed, L):
    rng = np.random.default_rng(seed)
    m = int(rng.choice([16, 57, 200]))
    a = rng.standard_normal(m)
    b_ext = rng.standard_normal(m + L)
    want = j_ref.lag_xdot_ref(jnp.asarray(a), jnp.asarray(b_ext), L=L)
    close(t_ref.lag_xdot(T(a), T(b_ext), L=L), want)
    close(t_ref.lag_xdot_ref(T(a), T(b_ext), L=L), want)
    close(t_ref.lag_dot_ref(T(a), L=L),
          j_ref.lag_dot_ref(jnp.asarray(a), L=L))


def test_gather_clamped_follows_jax_index_rule():
    x = np.arange(10.0)
    idx = np.array([-1, -3, -12, 0, 9, 12, 5], np.int32)
    exact(t_ref.gather_clamped(T(x), T(idx)), jnp.asarray(x)[idx])


# ---------------------------------------------------------------------------
# core/measures.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mae", "rmse", "nrmse", "mape", "cheb",
                                  "msmape", "psnr"])
def test_measures(name):
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal(24), rng.standard_normal(24)
    jf = getattr(j_meas, name)
    tf = getattr(t_meas, name)
    close(tf(T(a), T(b)), jf(jnp.asarray(a), jnp.asarray(b)))
    # batched rows reduce over the last axis (JAX gets this through vmap)
    rows = rng.standard_normal((6, 24))
    close(tf(T(rows), T(b)),
          jax.vmap(lambda r: jf(r, jnp.asarray(b)))(jnp.asarray(rows)))
    if name != "psnr":
        assert t_meas.get_measure(name) is tf
    with pytest.raises(ValueError):
        t_meas.get_measure("nope")


# ---------------------------------------------------------------------------
# core/acf.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kappa,L", [(1, 1), (1, 24), (4, 7)])
def test_extract_aggregates_and_acf(kappa, L):
    y, ny, _ = target(2 + L, 150, kappa)
    want = j_acf.extract_aggregates(jnp.asarray(y[:ny]), L)
    got = t_acf.extract_aggregates(T(y[:ny]), L)
    for g, w in zip(got, want):
        close(g, w)
    # padded bucket with a runtime valid length
    want_m = _j_masked(jnp.asarray(y), L, jnp.asarray(ny, jnp.int32))
    got_m = t_acf.extract_aggregates_masked(
        T(y), L, torch.tensor(ny, dtype=torch.int32))
    for g, w in zip(got_m, want_m):
        close(g, w)
    close(t_acf.acf_from_aggregates(got_m, torch.tensor(ny)),
          j_acf.acf_from_aggregates(want_m, ny))
    close(t_acf.acf(T(y[:ny]), L), j_acf.acf(jnp.asarray(y[:ny]), L))
    close(t_acf.pacf(T(y[:ny]), L), j_acf.pacf(jnp.asarray(y[:ny]), L))


@settings(max_examples=15, deadline=None)
@given(_SEED, st.sampled_from([1, 2, 5, 12]))
def test_pacf_from_acf(seed, L):
    rng = np.random.default_rng(seed)
    r = np.tanh(rng.standard_normal(L)) * 0.9
    close(t_acf.pacf_from_acf(T(r)), _j_pacf(r))
    # batched over leading rows (the port's vectorized form)
    rows = np.tanh(rng.standard_normal((3, L))) * 0.9
    close(t_acf.pacf_from_acf(T(rows)), _j_pacf_rows(rows))


@pytest.mark.parametrize("agg", ["mean", "sum", "max", "min"])
@pytest.mark.parametrize("kappa", [1, 4])
def test_aggregate_series(agg, kappa):
    x = np.random.default_rng(1).standard_normal(64)
    close(t_acf.aggregate_series(T(x), kappa, agg),
          j_acf.aggregate_series(jnp.asarray(x), kappa, agg))
    if kappa > 1:
        with pytest.raises(ValueError):
            t_acf.aggregate_series(T(x[:63]), kappa, agg)


# ---------------------------------------------------------------------------
# core/aggregates.py
# ---------------------------------------------------------------------------

def _dense_case(seed, L, kappa):
    y, ny, rng = target(seed, 96, kappa)
    agg = j_acf.extract_aggregates(jnp.asarray(y[:ny]), L)
    delta = np.zeros(y.shape[0])
    lo = int(rng.integers(0, max(ny - 12, 1)))
    delta[lo:lo + 12] = 0.4 * rng.standard_normal(min(12, ny - lo))
    ny_j = jnp.asarray(ny, jnp.int32)
    ny_t = torch.tensor(ny, dtype=torch.int32)
    want = _j_dense_ref(agg, y, delta, ny_j)
    table = T(np.stack(list(agg)))
    close(t_agg.apply_delta_dense(table, T(y), T(delta), ny=ny_t), want)
    tup = t_agg.apply_delta_dense(t_acf.Aggregates(*table), T(y), T(delta),
                                  ny=ny_t)
    assert isinstance(tup, t_acf.Aggregates)
    close(torch.stack(list(tup)), want)
    close(torch.stack(list(t_agg.apply_delta_dense_ref(
        table, T(y), T(delta), ny=ny_t))), want)


@pytest.mark.parametrize("L", [4, 12, 48])
@pytest.mark.parametrize("kappa", [1, 4])
def test_apply_delta_dense(L, kappa):
    _dense_case(7 * L + kappa, L, kappa)


@settings(max_examples=10, deadline=None)
@given(_SEED, _L, _KAPPA)
def test_apply_delta_dense_hypothesis(seed, L, kappa):
    _dense_case(seed, L, kappa)


def _geometry_case(seed, n, W):
    rng = np.random.default_rng(seed)
    alive = alive_mask(rng, n)
    x = rng.standard_normal(n)
    cand = rng.integers(0, n, 20).astype(np.int32)
    # an independent set: every third alive interior point
    removed = np.zeros(n, bool)
    removed[np.nonzero(alive)[0][1:-1:3]] = True
    j_prev, j_nxt, j_interp, jv, jd, (jp, jq) = _j_geometry(
        x, alive, cand, removed, W)

    t_prev, t_nxt = t_agg.alive_neighbors(T(alive))
    exact(t_prev, j_prev)
    exact(t_nxt, j_nxt)
    assert t_prev.dtype == torch.int32 and t_nxt.dtype == torch.int32
    idx = torch.arange(n, dtype=torch.int32)
    close(t_agg.interpolate_at(T(x), t_prev, t_nxt, idx), j_interp)
    tv = t_agg.segment_interp(T(x), t_prev, t_nxt, T(cand), W)
    close(tv[0], jv[0])
    for g, w in zip(tv[1:], jv[1:]):
        exact(g, w)
    td = t_agg.segment_deltas(T(x), t_prev, t_nxt, T(cand), W)
    close(td[0], jd[0])
    exact(td[1], jd[1])
    exact(td[2], jd[2])
    tp, tq = t_agg.neighbors_after_removal(t_prev, t_nxt, T(removed))
    exact(tp, jp)
    exact(tq, jq)
    # and it equals recomputing from scratch on the survivors
    rp, rq = t_agg.alive_neighbors(T(alive & ~removed))
    exact(tp, rp)
    exact(tq, rq)


@pytest.mark.parametrize("n,W", [(64, 8), (257, 64)])
def test_neighbor_geometry(n, W):
    _geometry_case(n, n, W)


@settings(max_examples=15, deadline=None)
@given(_SEED)
def test_neighbor_geometry_hypothesis(seed):
    _geometry_case(seed, 64, 8)
