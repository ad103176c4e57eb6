"""The port's ``select="scan"`` and its prefix-walk kernel against the JAX
package.

(a) ``prefix_devs_plain`` (the CUDA kernel's plain version), greedy and
    not, against ``prefix_devs_pallas`` in interpret mode on
    ``tests/test_backend.py``'s ``_prefix_setup``, and the greedy walk
    against that file's numpy oracle (from-scratch ACF per trial);
(b) the reference forms (``prefix_moment_rows``, ``prefix_acf_rows_ref``,
    ``prefix_devs``, ``greedy_feasible``) against JAX;
(c) ``greedy_take`` (the card's greedy branch) driven by the plain version
    against a numpy transcription of ``src/repro/core/cameo.py:470-483``;
(d) the deviation's gradient against ``jax.grad`` (the linearized
    packing), including round 0, where PyTorch's own derivative of ``abs``
    at 0 would rank differently;
(e) ``compress(select="scan")`` against JAX's CPU scan (the linearized
    branch) round by round and end to end: kept masks and iters
    identical, deviation within 1e-12.

As in ``tests/test_torch_cameo.py``, JAX's default compilation ("jit")
parts from the op-by-op values the port computes at float32 ranking
near-ties; those cases are held to JAX compiled without XLA's float32
rewrites ("strict", in a subprocess) or run op by op (ROADMAP.md C).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import cameo as jc
from repro.core import measures as j_measures
from repro.core.acf import acf as j_acf
from repro.core.acf import acf_from_aggregates, extract_aggregates
from repro.kernels import fused_round as j_fused
from repro.kernels import ops as j_ops
from repro_torch import convert
from repro_torch.core import cameo as tc
from repro_torch.core.acf import acf_from_aggregates as t_acf_from_aggregates
from repro_torch.kernels import fused_round as t_fused
from repro_torch.kernels import ref as t_ref
from test_torch_lag_order import row_sum_walk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)          # chip_smoke.py, at the repository root
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
FIELDS = ("xr", "alive", "prev", "nxt", "y", "tbl", "alpha", "dev", "rounds",
          "done", "blocked", "retried", "saw_c")


def T(a):
    return torch.from_numpy(np.array(a))


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (np.sin(2 * np.pi * t / 24) + 0.5 * np.sin(2 * np.pi * t / 168)
            + 0.15 * rng.standard_normal(n))


def _prefix_setup(seed=9, nyb=160, ny=150, K=12, Wy=16, L=8):
    """``tests/test_backend.py``'s fused-round inputs: y zero-padded beyond
    ny, candidate windows inside [0, ny)."""
    rng = np.random.default_rng(seed)
    y = np.zeros(nyb)
    y[:ny] = _series(ny, seed=seed)
    starts = rng.integers(0, ny - Wy, size=K).astype(np.int32)
    dyws = 0.1 * rng.standard_normal((K, Wy))
    ok = rng.random(K) > 0.25
    agg = extract_aggregates(jnp.asarray(y[:ny]), L)
    p0 = np.asarray(acf_from_aggregates(agg, ny))
    table = np.asarray(j_ops.agg_to_table(agg))
    return y, dyws, starts, ok, table, p0


# end-to-end cases -> the JAX compilation the port is held to
E2E = {"k1": "jit", "k4": "strict", "rmse": "strict", "cheb": "strict",
       "target_cr": "jit", "first_violation": "jit", "single": "jit"}
OPTS = {"k1": dict(), "k4": dict(kappa=4), "rmse": dict(measure="rmse"),
        "cheb": dict(measure="cheb"), "target_cr": dict(target_cr=6.0),
        "first_violation": dict(stop_policy="first_violation"),
        "single": dict(rank="single"), "pacf": dict(stat="pacf")}


def _cfg(name):
    return jc.CameoConfig(eps=0.02, lags=12, select="scan",
                          backend="reference", **OPTS[name])


# window lengths of the strict Pallas walks (one block of XLA's row-reduce
# and past it)
PALLAS_WY = (16, 40)


def _reference_main(out_path, jobs):
    """Subprocess entry: JAX's end-to-end results for ``jobs``, saved as
    npz (the caller picks the compilation through XLA_FLAGS)."""
    jax.config.update("jax_enable_x64", True)
    res = {}
    for job in jobs:
        r = jc.compress_rounds(jnp.asarray(_series(768, 4)), _cfg(job))
        res[f"{job}/kept"] = np.asarray(r.kept)
        res[f"{job}/iters"] = np.asarray(r.iters)
        res[f"{job}/deviation"] = np.asarray(r.deviation)
    # the Pallas prefix walk in interpret mode, with its inputs
    names = ("y", "dyws", "starts", "ok", "table", "p0")
    for Wy in PALLAS_WY:
        inputs = _prefix_setup(seed=11, Wy=Wy)
        res.update({f"pallas{Wy}/{k}": v for k, v in zip(names, inputs)})
        for measure in ("mae", "rmse", "cheb"):
            for greedy in (False, True):
                res[f"pallas{Wy}/{measure}/{greedy}"] = np.asarray(
                    j_fused.prefix_devs_pallas(
                        *map(jnp.asarray, inputs), 150, 0.005, L=8,
                        measure=measure, greedy=greedy, interpret=True))
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def strict(tmp_path_factory):
    """JAX's "strict" end-to-end results, computed in a subprocess started
    when the first test asks for them."""
    out = tmp_path_factory.mktemp("jax_strict") / "strict.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    jobs = [name for name, kind in E2E.items() if kind == "strict"]
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", str(out),
         *jobs], env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# (a) the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
def test_prefix_devs_plain_matches_pallas(measure, greedy, strict):
    """Bit for bit against the Pallas walk compiled strictly (C13), at
    Wy = 16 and 40 (past one block of XLA's row-reduce); within 1e-15 of
    the default-compiled one in this process, which divides by its rsqrt
    product (C1)."""
    L, ny, eps = 8, 150, 0.005
    for Wy in PALLAS_WY:
        names = ("y", "dyws", "starts", "ok", "table", "p0")
        y, dyws, starts, ok, table, p0 = (strict[f"pallas{Wy}/{k}"]
                                          for k in names)
        args = (T(y), T(dyws), T(starts), T(ok), T(table), T(p0),
                torch.tensor(ny, dtype=torch.int32), eps)
        got = t_fused.prefix_devs_plain(*args, L=L, measure=measure,
                                        greedy=greedy)
        # CPU tensors: the wrapper is the plain version
        torch.testing.assert_close(t_fused.prefix_devs_cuda(
            *args, L=L, measure=measure, greedy=greedy), got, rtol=0, atol=0)
        want = strict[f"pallas{Wy}/{measure}/{greedy}"]
        np.testing.assert_array_equal(got.numpy(), want)
        jit = np.asarray(j_fused.prefix_devs_pallas(
            *map(jnp.asarray, (y, dyws, starts, ok, table, p0)), ny, eps,
            L=L, measure=measure, greedy=greedy, interpret=True))
        np.testing.assert_allclose(got.numpy(), jit, rtol=0, atol=1e-15)
        if greedy:
            # the run commits and skips: the decisions tell the forms apart
            take = ok & (want <= eps)
            assert 0 < take.sum() < ok.sum()
            np.testing.assert_array_equal(ok & (got.numpy() <= eps), take)


def test_prefix_devs_plain_greedy_matches_oracle():
    """The greedy walk against ``test_backend.py``'s numpy oracle, which
    rebuilds the reconstruction and recomputes the ACF from scratch at
    every trial."""
    y, dyws, starts, ok, table, p0 = _prefix_setup(seed=11)
    L, ny, eps = 8, 150, 0.02
    K, Wy = dyws.shape
    devs = t_fused.prefix_devs_plain(
        T(y), T(dyws), T(starts), T(ok), T(table), T(p0), ny, eps, L=L,
        measure="mae", greedy=True).numpy()
    z = y.copy()
    oracle_devs, oracle_take = [], []
    for k in range(K):
        s = int(starts[k])
        trial = z.copy()
        trial[s:s + Wy] += dyws[k] * float(ok[k])
        dev = float(j_measures.mae(j_acf(jnp.asarray(trial[:ny]), L), p0))
        commit = bool(ok[k]) and dev <= eps
        if commit:
            z = trial
        oracle_devs.append(dev)
        oracle_take.append(commit)
    np.testing.assert_allclose(devs, oracle_devs, rtol=1e-8, atol=1e-9)
    assert min(abs(d - eps) for d in oracle_devs) > 1e-6
    np.testing.assert_array_equal(ok & (devs <= eps), oracle_take)


OK_KINDS = {
    # random, with a leading run and one whole chunk (of 16) not ok
    "mixed": lambda rng, K: np.r_[np.zeros(5, bool), rng.random(11) > 0.3,
                                  np.zeros(16, bool),
                                  rng.random(K - 32) > 0.4],
    "none": lambda rng, K: np.zeros(K, bool),
    "all": lambda rng, K: np.ones(K, bool),
}


def _walk_corpus(seed, ok_kind, *, nyb=160, ny=150, K=50, Wy=12, L=8):
    """Prefix-walk inputs whose candidates cover the kernel's cases:
    interior windows, windows with s < L or s + Wy + L > ny, starts the
    walk clips into [0, nyb), and runs of overlapping consecutive windows;
    ``ok`` after ``OK_KINDS[ok_kind]``."""
    rng = np.random.default_rng(seed)
    y = np.zeros(nyb)
    y[:ny] = _series(ny, seed=seed)
    starts = rng.integers(L, ny - Wy - L, size=K)
    starts[1::6] = rng.integers(0, L, size=len(starts[1::6]))
    starts[2::6] = rng.integers(ny - Wy - L + 1, ny, size=len(starts[2::6]))
    starts[3::6] = starts[2::6][:len(starts[3::6])] - 3
    starts[4::6] = starts[3::6][:len(starts[4::6])] + 2
    starts[5::12] = -2
    starts[11::24] = nyb + 5
    dyws = 0.1 * rng.standard_normal((K, Wy))
    ok = OK_KINDS[ok_kind](rng, K)
    agg = extract_aggregates(jnp.asarray(y[:ny]), L)
    p0 = np.asarray(acf_from_aggregates(agg, ny))
    table = np.asarray(j_ops.agg_to_table(agg))
    return y, dyws, starts.astype(np.int32), ok, table, p0


def _committed_devs(devs, ok, table, p0, ny, eps, *, L, measure, greedy):
    """The deviation committed before each rank, from a walk's outputs
    ``devs``: that of ``table`` itself, then the output of each ok rank that
    commits (every ok rank unless ``greedy``)."""
    m = (ny - torch.arange(1, L + 1)).to(table.dtype)
    dev_c = t_ref.measure_rows(t_ref.acf_from_table(table, m)[None], p0,
                               measure)[0]
    out = []
    for k in range(devs.shape[0]):
        out.append(dev_c)
        if ok[k] and (not greedy or devs[k] <= eps):
            dev_c = devs[k]
    return torch.stack(out)


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
@pytest.mark.parametrize("ok_kind", list(OK_KINDS))
def test_prefix_devs_skip_identity(ok_kind, measure, greedy):
    """A rank that is not ok adds a zero delta: its output is the deviation
    committed before it.  Bit for bit on the plain version (the kernel
    fills such ranks with it and walks only the ok ones), to 1e-12 on the
    Pallas kernel."""
    L, ny, eps = 8, 150, 0.004
    y, dyws, starts, ok, table, p0 = _walk_corpus(5, ok_kind)
    args = (T(y), T(dyws), T(starts), T(ok), T(table), T(p0),
            torch.tensor(ny, dtype=torch.int32), eps)
    got = t_fused.prefix_devs_plain(*args, L=L, measure=measure,
                                    greedy=greedy)
    want = T(j_fused.prefix_devs_pallas(
        jnp.asarray(y), jnp.asarray(dyws), jnp.asarray(starts),
        jnp.asarray(ok), jnp.asarray(table), jnp.asarray(p0), ny, eps, L=L,
        measure=measure, greedy=greedy, interpret=True))
    skip = ~T(ok)
    kw = dict(L=L, measure=measure, greedy=greedy)
    c_plain = _committed_devs(got, ok, T(table), T(p0), ny, eps, **kw)
    c_pallas = _committed_devs(want, ok, T(table), T(p0), ny, eps, **kw)
    torch.testing.assert_close(got[skip], c_plain[skip], rtol=0, atol=0)
    torch.testing.assert_close(want[skip], c_pallas[skip], rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    if greedy and ok_kind == "mixed":
        take = ok & (got.numpy() <= eps)
        assert 0 < take.sum() < ok.sum()


def _schedule_walk(y, dyws, ystarts, ok, table, p0, ny, eps, *, L, measure,
                   greedy, chunk=16):
    """The prefix walk in the order of the ``prefix_devs`` kernel's
    schedule, one rounded operation at a time: the ranks in chunks, only
    each chunk's ok ranks walked, the others filled from the committed
    deviation after the last ok rank before them; interior candidates (s >=
    L and s + Wy + L <= ny) with the sums of d and e shared by every lag and
    one sum of products per lag; boundary candidates with the masked sums
    of ``rn::window_term<false>``, lag by lag; every window sum in XLA's
    row-reduce order (``rn::row_sums``)."""
    K, Wy = dyws.shape
    nyb, dt = y.shape[0], y.dtype
    z = F.pad(y, (L, L + Wy))
    agg = table
    l = torch.arange(1, L + 1)
    m = (ny - l).to(dt)

    def in_order(terms):             # first to last over the last axis
        acc = terms[..., 0]
        for j in range(1, terms.shape[-1]):
            acc = acc + terms[..., j]
        return acc

    def window_sum(terms):           # rn::row_sums over the last axis
        return row_sum_walk([terms[..., j] for j in range(terms.shape[-1])])

    def deviation(sums):
        trial = agg + sums
        df = t_ref.acf_from_table(trial, m) - p0
        if measure == "cheb":
            return torch.amax(torch.abs(df)), trial
        acc = in_order(df * df if measure == "rmse" else torch.abs(df))
        acc = acc / torch.full((), L, dtype=dt)
        return (torch.sqrt(acc) if measure == "rmse" else acc), trial

    dev_c, _ = deviation(torch.zeros((5, L), dtype=dt))
    out = torch.empty(K, dtype=dt)
    for base in range(0, K, chunk):
        okc = ok[base:base + chunk]
        before = torch.cumsum(okc.long(), 0) - okc.long()
        start, after = dev_c, []
        for p in torch.nonzero(okc).view(-1).tolist():
            k = base + p
            s = int(ystarts[k].clamp(0, nyb - 1))
            d = dyws[k]
            zc = z[s:s + 2 * L + Wy]       # zc[L + j]: y[s + j] and after
            e = d * (2.0 * zc[L:L + Wy] + d)
            d_pad = F.pad(d, (0, L))
            if s >= L and s + Wy + L <= ny:
                sd, se = window_sum(d), window_sum(e)
                prod = torch.stack([d * ((zc[L + lag:L + lag + Wy]
                                          + zc[L - lag:L - lag + Wy])
                                         + d_pad[lag:lag + Wy])
                                    for lag in range(1, L + 1)])
                sums = torch.stack([sd.expand(L), sd.expand(L),
                                    se.expand(L), se.expand(L),
                                    window_sum(prod)])
            else:
                cols = []
                for j in range(Wy):
                    h = (s + j <= ny - 1 - l).to(dt)
                    tl = (s + j >= l).to(dt)
                    inner = (zc[L + j + l] * h + zc[L + j - l] * tl) \
                        + d_pad[j + l] * h
                    cols.append(torch.stack([d[j] * h, d[j] * tl, e[j] * h,
                                             e[j] * tl, d[j] * inner]))
                sums = row_sum_walk(cols)
            dev, trial = deviation(sums)
            out[k] = dev
            if not greedy or dev <= eps:
                dev_c, agg = dev, trial
                z = z.index_put((s + L + torch.arange(Wy),), zc[L:L + Wy] + d)
            after.append(dev_c)
        for p in range(okc.shape[0]):
            if not okc[p]:
                c = int(before[p])
                out[base + p] = start if c == 0 else after[c - 1]
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
@pytest.mark.parametrize("ok_kind", list(OK_KINDS))
def test_prefix_devs_schedule_matches_plain(ok_kind, measure, greedy, dtype):
    """The kernel's schedule (chunks of 16 here, so K = 50 spans four)
    against the plain walk, bit for bit."""
    L, ny = 8, 150
    y, dyws, starts, ok, table, p0 = _walk_corpus(7, ok_kind)
    args = [T(a).to(dtype) for a in (y, dyws)] + [T(starts), T(ok)] + [
        T(a).to(dtype) for a in (table, p0)]
    kw = dict(L=L, measure=measure)
    curve = t_fused.prefix_devs_plain(*args, ny, **kw)
    eps = torch.sort(curve).values[25]
    want = t_fused.prefix_devs_plain(*args, ny, eps, greedy=greedy, **kw)
    got = _schedule_walk(*args, ny, eps, greedy=greedy, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    s = np.clip(starts, 0, 159)
    interior = (s >= L) & (s + 12 + L <= ny)
    assert interior.any() and (~interior).any()


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("Wy", [33, 40, 64])
def test_prefix_devs_schedule_long_windows(Wy, greedy):
    """Past 32 window values the kernel's window sums walk XLA's blocks
    (``rn::row_sums``), as the plain walk does: bit for bit."""
    L, ny = 8, 150
    y, dyws, starts, ok, table, p0 = _walk_corpus(8, "mixed", K=40, Wy=Wy)
    args = [T(a) for a in (y, dyws)] + [T(starts), T(ok)] + [
        T(a) for a in (table, p0)]
    kw = dict(L=L, measure="mae")
    curve = t_fused.prefix_devs_plain(*args, ny, **kw)
    eps = torch.sort(curve).values[20]
    want = t_fused.prefix_devs_plain(*args, ny, eps, greedy=greedy, **kw)
    got = _schedule_walk(*args, ny, eps, greedy=greedy, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (b) the reference forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", ["mae", "rmse", "cheb"])
def test_prefix_reference_forms_match_jax(measure):
    y, dyws, starts, ok, table, p0 = _prefix_setup()
    L, ny, eps = 8, 150, 0.02
    J = [jnp.asarray(a) for a in (y, dyws, starts, ok)]
    Tt = [T(a) for a in (y, dyws, starts, ok)]
    np.testing.assert_allclose(
        t_fused.prefix_moment_rows(*Tt, ny, L=L).numpy(),
        np.asarray(j_fused.prefix_moment_rows(*J, ny, L=L)),
        rtol=1e-10, atol=1e-10)
    rows = t_fused.prefix_acf_rows_ref(*Tt, T(table), ny, L=L)
    np.testing.assert_allclose(
        rows.numpy(), np.asarray(j_fused.prefix_acf_rows_ref(
            *J, jnp.asarray(table), ny, L=L)), rtol=1e-10, atol=1e-10)
    jcfg = jc.CameoConfig(lags=L, measure=measure, backend="reference")
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    np.testing.assert_allclose(
        t_fused.prefix_devs(tcfg, *Tt, T(table), T(p0), ny).numpy(),
        np.asarray(j_fused.prefix_devs(jcfg, *J, jnp.asarray(table),
                                       jnp.asarray(p0), ny)),
        rtol=1e-9, atol=1e-9)
    take_j, devs_j = j_fused.greedy_feasible(
        jcfg, *J, jnp.asarray(table), jnp.asarray(p0), ny, eps)
    take_t, devs_t = t_fused.greedy_feasible(
        tcfg, *Tt, T(table), T(p0), ny, torch.tensor(eps, dtype=torch.float64))
    np.testing.assert_allclose(devs_t.numpy(), np.asarray(devs_j),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(take_t.numpy(), np.asarray(take_j))


# ---------------------------------------------------------------------------
# (c) the greedy decision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.0045, 0.0075, 0.02])
@pytest.mark.parametrize("seed", [9, 11, 13])
def test_greedy_take_matches_transcription(seed, eps):
    y, dyws, starts, ok, table, p0 = _prefix_setup(seed=seed)
    L, ny = 8, 150
    take_g, take_pre, more = tc.greedy_take(
        t_fused.prefix_devs_plain, T(y), T(dyws), T(starts), T(ok), T(table),
        T(p0), torch.tensor(ny, dtype=torch.int32),
        torch.tensor(eps, dtype=torch.float64), L=L, measure="mae")
    # src/repro/core/cameo.py:470-483, with the devs of the Pallas walk
    devs = np.asarray(j_fused.prefix_devs_pallas(
        jnp.asarray(y), jnp.asarray(dyws), jnp.asarray(starts),
        jnp.asarray(ok), jnp.asarray(table), jnp.asarray(p0), ny, eps, L=L,
        measure="mae", greedy=True, interpret=True))
    want_g = ok & (devs <= eps)
    K = ok.shape[0]
    ar0 = np.arange(K)
    first_skip = np.min(np.where(ok & (~want_g), ar0, K))
    want_pre = want_g & (ar0 < first_skip)
    np.testing.assert_array_equal(take_g.numpy(), want_g)
    np.testing.assert_array_equal(take_pre.numpy(), want_pre)
    assert bool(more) == bool(want_g.sum() > want_pre.sum())


# ---------------------------------------------------------------------------
# (d) the linearized packing's gradient
# ---------------------------------------------------------------------------

def _round_state(name, rounds):
    """The JAX carry after ``rounds`` jitted scan rounds, and p0."""
    x, jcfg = _series(768, 4), _cfg(name)
    n = 768
    nb = jc._round_bucket(n, jcfg)
    min_alive, eps = jc._halting_params(n, jcfg)
    nv = jnp.asarray(n, jnp.int32)
    carry, p0 = jax.jit(lambda xp, nv: jc._rounds_init(xp, nv, jcfg))(
        jnp.pad(jnp.asarray(x), (0, nb - n)), nv)
    step = jax.jit(functools.partial(jc._rounds_chunk, cfg=jcfg, budget=1))
    out = [carry]
    for _ in range(rounds):
        carry, _ = step(carry, nv, jnp.asarray(min_alive, jnp.int32),
                        jnp.asarray(eps), p0)
        out.append(carry)
    return [[np.asarray(a) for a in c] for c in out], np.asarray(p0)


@pytest.mark.parametrize("name", ["k1", "cheb", "rmse", "pacf"])
def test_deviation_grad_matches_jax(name):
    jcfg = _cfg(name)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    mfn, transform = jc._measure_fn(jcfg), jc._stat_transform(jcfg)
    carries, _ = _round_state(name, 3)
    for k in (0, 3):
        tbl = carries[k][5]
        # each package's own p0 from the same table: round 0 sits at a
        # kink of every lag (|rho - p0| = 0 exactly)
        p0_j = transform(acf_from_aggregates(jnp.asarray(tbl), 768))
        p0_t = tc._stat_transform(tcfg)(t_acf_from_aggregates(T(tbl), 768))
        want = np.asarray(jax.grad(lambda t5: mfn(transform(
            acf_from_aggregates(t5, 768)), p0_j))(jnp.asarray(tbl)))
        got = tc._deviation_grad(tcfg, T(tbl), torch.tensor(768), p0_t)
        got = got.numpy()
        if name == "rmse" and k == 0:
            # d sqrt at 0: NaN in both frameworks
            assert np.isnan(want).all() and np.isnan(got).all()
            continue
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-12 * np.max(np.abs(want)))


def test_round_zero_subgradient_trap():
    """At round 0 the table is the original's, so every lag sits at
    |rho - p0| = 0.  JAX's derivative of abs there is +1 and the port's
    measures follow it; PyTorch's own (0) would zero the whole gradient
    and leave the linearized order to the index."""
    jcfg = _cfg("k1")
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    carries, p0 = _round_state("k1", 1)
    tbl = T(carries[0][5])
    p0_t = t_acf_from_aggregates(tbl, 768)
    g = tc._deviation_grad(tcfg, tbl, torch.tensor(768), p0_t)
    with torch.enable_grad():
        t = tbl.clone().requires_grad_(True)
        dev = torch.mean(torch.abs(t_acf_from_aggregates(t, 768) - p0_t))
        (g_torch,) = torch.autograd.grad(dev, t)
    assert float(torch.max(torch.abs(g))) > 0
    assert float(torch.max(torch.abs(g_torch))) == 0.0
    # and round 0 of the port's scan equals JAX's
    got = _port_round("k1", carries[0], p0)
    assert _mismatch(got, carries[1]) == []


# ---------------------------------------------------------------------------
# (e) rounds and end to end
# ---------------------------------------------------------------------------

def _port_round(name, carry_np, p0):
    jcfg = _cfg(name)
    n = 768
    nb = jc._round_bucket(n, jcfg)
    min_alive, eps = jc._halting_params(n, jcfg)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    probe, body = tc._round_fns(
        tcfg, nb, torch.tensor([n], dtype=torch.int32),
        torch.tensor([min_alive], dtype=torch.int32),
        torch.tensor([eps], dtype=torch.float64), T(p0)[None])
    carry = convert.carry_from_numpy(carry_np, "cpu")
    ((go, small),) = probe(carry).tolist()
    assert go
    return convert.carry_to_numpy(body(carry, small=small))


def _mismatch(got, want):
    bad = []
    for f, g, w in zip(FIELDS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if w.dtype.kind == "f":
            if not np.allclose(g, w, rtol=0.0, atol=1e-10):
                bad.append(f)
        elif not np.array_equal(g, w):
            bad.append(f)
    return bad


@pytest.mark.parametrize("name", ["k1", "single", "first_violation"])
def test_scan_rounds_match_reference(name):
    carries, p0 = _round_state(name, 11)
    for k in (0, 3, 10):
        assert _mismatch(_port_round(name, carries[k], p0),
                         carries[k + 1]) == [], k


def test_scan_pacf_rounds_and_near_tie():
    """PACF: the port holds JAX's jitted rounds until round 52, where the
    float32 PACF ranking rows of points 74 and 76 tie within XLA's
    rewrites; there the port equals JAX run op by op (ROADMAP.md C)."""
    name = "pacf"
    carries, p0 = _round_state(name, 53)
    for k in range(0, 52, 3):
        assert _mismatch(_port_round(name, carries[k], p0),
                         carries[k + 1]) == [], k
    got = _port_round(name, carries[52], p0)
    assert _mismatch(got, carries[53]) == ["blocked"]
    jcfg = _cfg(name)
    min_alive, eps = jc._halting_params(768, jcfg)
    with jax.disable_jit():
        op, _ = jc._rounds_chunk(
            tuple(jnp.asarray(a) for a in carries[52]),
            jnp.asarray(768, jnp.int32), jnp.asarray(min_alive, jnp.int32),
            jnp.asarray(eps), jnp.asarray(p0), cfg=jcfg, budget=1)
    assert _mismatch(got, [np.asarray(a) for a in op]) == []


@pytest.mark.parametrize("name", list(E2E))
def test_scan_end_to_end(name, strict):
    import chip_smoke
    x = _series(768, 4)
    jcfg = _cfg(name)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    got = tc.compress(x, tcfg, device="cpu")
    if E2E[name] == "jit":
        r = jc.compress_rounds(jnp.asarray(x), jcfg)
        kept, iters, dev = r.kept, r.iters, r.deviation
    else:
        kept, iters, dev = (strict[f"{name}/{f}"]
                            for f in ("kept", "iters", "deviation"))
    np.testing.assert_array_equal(got.kept.numpy(), np.asarray(kept))
    assert int(got.iters) == int(iters)
    assert abs(float(got.deviation) - float(dev)) <= 1e-12
    k, xr = got.kept.numpy(), got.xr.numpy()
    assert k[0] and k[-1]
    np.testing.assert_array_equal(xr[k], x[k])
    if tcfg.target_cr is None:
        assert float(got.deviation) <= tcfg.eps
    assert abs(chip_smoke.remeasure(x, xr, tcfg)
               - float(got.deviation)) <= 1e-9


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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", ["warp", "block"])
@pytest.mark.parametrize("nyb,ny", [(160, 150), (60000, 59000)])
def test_gpu_prefix_devs(cuda, nyb, ny, form, dtype):
    """Bit for bit equal to the plain version: z in shared memory (nyb =
    160) and in the global-scratch layout (nyb = 60,000: z outgrows 227
    KB); the one-warp block (L <= 32) and a two-warp one (L = 36); every
    rank ok, none ok, and K = 1,300 across two chunks of 1,024 with
    interior, boundary, clipped and overlapping windows."""
    L, Wy = (8, 12) if form == "warp" else (36, 40)
    use_smem = t_fused.prefix_devs_layout(
        Wy, nyb, L, torch.empty((), dtype=dtype).element_size())
    assert use_smem == (nyb == 160)
    for ok_kind, K in (("mixed", 1300), ("none", 60), ("all", 60)):
        y, dyws, starts, ok, table, p0 = _walk_corpus(
            11, ok_kind, nyb=nyb, ny=ny, K=K, Wy=Wy, L=L)
        args = [T(a).to(cuda, dtype) for a in (y, dyws)]
        args += [T(starts).to(cuda), T(ok).to(cuda)]
        args += [T(a).to(cuda, dtype) for a in (table, p0)]
        args.append(torch.tensor([ny], dtype=torch.int32, device=cuda))
        curve = t_fused.prefix_devs_plain(*args, L=L)
        args.append(torch.sort(curve).values[K // 2].reshape(1))
        for greedy in (False, True):
            for measure in ("mae", "rmse", "cheb"):
                got = t_fused.prefix_devs_cuda(*args, L=L, measure=measure,
                                               greedy=greedy)
                want = t_fused.prefix_devs_plain(*args, L=L,
                                                 measure=measure,
                                                 greedy=greedy)
                torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("nyb,ny", [(3000, 2900), (60000, 59000)])
@pytest.mark.parametrize("L", [513, 1024])
def test_gpu_prefix_devs_many_lags(cuda, L, nyb, ny):
    """Past 512 lags (a thread takes two, the moments of lags 513.. sit in
    global scratch): bit for bit equal to the plain version, greedy and
    not, under every measure, with z in shared memory (nyb = 3,000) and in
    global scratch (nyb = 60,000), on interior, boundary, clipped and
    overlapping windows."""
    y, dyws, starts, ok, table, p0 = _walk_corpus(
        L, "mixed", nyb=nyb, ny=ny, K=60, Wy=12, L=L)
    args = [T(a).to(cuda) for a in (y, dyws, starts, ok, table, p0)]
    args.append(torch.tensor([ny], dtype=torch.int32, device=cuda))
    curve = t_fused.prefix_devs_plain(*args, L=L)
    args.append(torch.sort(curve).values[30].reshape(1))
    for greedy in (False, True):
        for measure in ("mae", "rmse", "cheb"):
            kw = dict(L=L, measure=measure, greedy=greedy)
            torch.testing.assert_close(
                t_fused.prefix_devs_cuda(*args, **kw),
                t_fused.prefix_devs_plain(*args, **kw), rtol=0, atol=0)


@pytest.mark.gpu
def test_gpu_scan_past_512_lags(cuda):
    """compress(select="scan") at L = 513 on the card: the greedy branch
    walks through the prefix_devs kernel, and the guarantee holds."""
    x = _series(4096, seed=3)
    cfg = tc.CameoConfig(eps=0.02, lags=513, select="scan")
    before = t_fused.prefix_devs_cuda.launches
    res = tc.compress(x, cfg, device=cuda)
    assert t_fused.prefix_devs_cuda.launches > before
    import chip_smoke
    dev = float(res.deviation)
    assert dev <= cfg.eps + 1e-12
    assert abs(chip_smoke.remeasure(x, res.xr.cpu().numpy(), cfg) - dev) \
        <= 1e-9
    assert int(res.n_kept) < x.shape[0]


@pytest.mark.gpu
def test_gpu_scan_greedy_lockstep(cuda):
    """One scan round's greedy decisions on the card: kernel and plain
    version take the same candidates."""
    y, dyws, starts, ok, table, p0 = _prefix_setup(seed=13, K=64)
    args = [T(a).to(cuda) for a in (y, dyws, starts, ok, table, p0)]
    args += [torch.tensor([150], dtype=torch.int32, device=cuda),
             torch.tensor([0.02], dtype=torch.float64, device=cuda)]
    a = tc.greedy_take(t_fused.prefix_devs_cuda, *args, L=8, measure="mae")
    b = tc.greedy_take(t_fused.prefix_devs_plain, *args, L=8, measure="mae")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_main(sys.argv[2], sys.argv[3:])
