"""The partitioned mode (``repro_torch.core.parallel``) and
``compress_batch(mesh=)`` against the JAX package.

(a) ``chunk_agg_contrib`` and ``chunk_delta_contrib`` over a partition axis,
    summed over partitions, give the reference's aggregates bit for bit
    (``tests/test_parallel.py``'s inputs);
(b) ``compress_partitioned`` equals the reference in kept mask,
    iterations, reconstruction, deviation and statistics bits, on
    ``_series(1024, seed=3)`` at L = 12, T = 4 and on a kappa = 48 series
    (n = 6,912, L = 7, T = 2); its guarantee holds and its deviation equals
    a from-scratch re-measure of the decompressed series;
(c) ``compress_partitioned_local`` equals the reference's kept mask,
    reconstruction and deviation;
(d) the shard form on gloo at world size 4 equals the port's global form in
    every field bit for bit, and ``compress_batch(mesh=)`` at world size 2
    equals the unsharded batch and raises on a batch of 3;
(e) a bad T or kappa raises as the reference's ``_plan`` does;
plus, on a card only, the global form against its CPU run and the shard
form and ``mesh=`` on NCCL at world size 1.

The reference runs compiled without XLA's float rewrites
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``,
ROADMAP C1), in a subprocess; the gloo ranks are processes spawned with a
``file://`` rendezvous in a temporary directory.
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
import torch.multiprocessing as mp

from repro.core import cameo as jc
from repro.core import measures as jm
from repro.core import parallel as jpar
from repro.core.acf import acf as j_acf
from repro.core.cameo import CameoConfig as JConfig
from repro_torch import convert
from repro_torch import sharding as shd
from repro_torch.core import cameo as tc
from repro_torch.core import parallel as tpar
from repro_torch.core.acf import acf as t_acf
from repro_torch.core.measures import get_measure
from repro_torch.data.synthetic import make_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
RESULT_FIELDS = ("kept", "xr", "deviation", "n_kept", "iters", "stat_orig",
                 "stat_new")
# compress_partitioned cases: (series, config, T)
CASES = {
    "uk": (("series", 1024, 3), dict(eps=0.02, lags=12), 4),
    "kappa48": (("aus_elec", 6912, 0), dict(eps=0.02, lags=7, kappa=48), 2),
}
BATCH = dict(eps=0.05, lags=8)


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.sin(2 * np.pi * t / 24) + 0.15 * rng.standard_normal(n)


def _data(spec):
    kind, n, seed = spec
    if kind == "series":
        return _series(n, seed)
    return make_dataset(kind, seed=seed, length=n)


def _tcfg(**kw):
    return convert.config_from_dict(dataclasses.asdict(
        JConfig(dtype="float64", **kw)))


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and np.array_equal(
        np.atleast_1d(a).view(np.uint8), np.atleast_1d(b).view(np.uint8))


def _contrib_inputs():
    """``tests/test_parallel.py``'s inputs: the aggregate contributions of
    n = 1,024, L = 12, T = 4, and the delta contributions of n = 512,
    L = 8, T = 4."""
    x = _series(1024)
    d_x = _series(512, seed=1)
    delta = np.random.default_rng(2).standard_normal(512) * 0.1
    return x, d_x, delta


def _halos(parts, L):
    return np.concatenate([parts[1:, :L], np.zeros((1, L))], axis=0)


def _reference(out_path):
    """Strict-compiled JAX: the contributions' sums, the partitioned runs
    and the local-budget run."""
    jax.config.update("jax_enable_x64", True)
    out = {}
    x, d_x, delta = _contrib_inputs()
    for name, (series, L, T) in (("agg", (x, 12, 4)),
                                 ("delta", (d_x, 8, 4))):
        n = series.shape[0]
        m = n // T
        yp = series.reshape(T, m)
        offs = jnp.arange(T, dtype=jnp.int32) * m
        if name == "agg":
            contribs = jax.jit(jax.vmap(
                lambda yc, hr, off: jpar.chunk_agg_contrib(yc, hr, off, n, L)
            ))(yp, _halos(yp, L), offs)
        else:
            dp = delta.reshape(T, m)
            contribs = jax.jit(jax.vmap(
                lambda yc, dc, a, b, off: jpar.chunk_delta_contrib(
                    yc, dc, a, b, off, n, L)))(
                yp, dp, _halos(yp, L), _halos(dp, L), offs)
        summed = jax.jit(lambda c: jax.tree.map(lambda a: a.sum(0), c))(
            contribs)
        out[f"{name}/table"] = np.stack([np.asarray(a) for a in summed])
    for case, (spec, kw, T) in CASES.items():
        r = jpar.compress_partitioned(jnp.asarray(_data(spec)),
                                      JConfig(dtype="float64", **kw), T=T)
        for f in RESULT_FIELDS:
            out[f"{case}/{f}"] = np.asarray(getattr(r, f))
    cfg = JConfig(eps=0.02, lags=12, dtype="float64")
    x = _series(1024, seed=4)
    r = jpar.compress_partitioned_local(x, cfg, T=4)
    for f in RESULT_FIELDS:
        out[f"local/{f}"] = np.asarray(getattr(r, f))
    # the same with every partition compressed alone (its solo run), merged
    # and measured as compress_partitioned_local does
    local = dataclasses.replace(cfg, eps=cfg.eps / 4)
    solo = [jc.compress_rounds(jnp.asarray(c), local)
            for c in x.reshape(4, 256)]
    kept = jnp.concatenate([s.kept for s in solo])
    xr = jnp.concatenate([s.xr for s in solo])
    s0 = j_acf(jnp.asarray(x), 12)
    s1 = j_acf(xr, 12)
    for f, v in (("kept", kept), ("xr", xr), ("stat_orig", s0),
                 ("stat_new", s1), ("deviation", jm.mae(s1, s0)),
                 ("n_kept", jnp.sum(kept)),
                 ("iters", jnp.max(jnp.stack([s.iters for s in solo])))):
        out[f"solo/{f}"] = np.asarray(v)
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
    out = tmp_path_factory.mktemp("jax_strict_parallel") / "strict.npz"
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


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, rdv, out_dir, job):
    """One gloo rank: the shard form of the "uk" case, or
    ``compress_batch(mesh=)`` of four series and of three."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        mesh = shd.mesh_1d("cpu")
        if job == "shard":
            spec, kw, _ = CASES["uk"]
            res = tpar.compress_partitioned_shardmap(_data(spec),
                                                     _tcfg(**kw), mesh)
            saved = res._asdict()
        else:
            xs = np.stack([_series(512, seed=s) for s in range(4)])
            saved = tc.compress_batch(xs, _tcfg(**BATCH), mesh=mesh)._asdict()
            try:
                tc.compress_batch(xs[:3], _tcfg(**BATCH), mesh=mesh)
            except ValueError as err:
                saved["uneven"] = str(err)
        torch.save(saved, os.path.join(out_dir, f"{job}{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path_factory, job, world):
    out = tmp_path_factory.mktemp(f"gloo_{job}")
    ctx = mp.spawn(_rank_main, args=(world, str(out / "rdv"), str(out), job),
                   nprocs=world, join=False)
    cache = {}

    def get():
        if not cache:
            while not ctx.join(timeout=600):
                pass
            cache.update({r: torch.load(out / f"{job}{r}.pt")
                          for r in range(world)})
        return cache

    yield get
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def shard_ranks(tmp_path_factory):
    """The shard form on four gloo ranks, started when first asked for."""
    yield from _spawn(tmp_path_factory, "shard", 4)


@pytest.fixture(scope="module")
def batch_ranks(tmp_path_factory):
    """``compress_batch(mesh=)`` on two gloo ranks."""
    yield from _spawn(tmp_path_factory, "batch", 2)


@pytest.fixture(scope="module")
def port_runs():
    """The port's global-form runs of the cases, on the CPU."""
    return {case: tpar.compress_partitioned(_data(spec), _tcfg(**kw), T,
                                            device="cpu")
            for case, (spec, kw, T) in CASES.items()}


# ---------------------------------------------------------------------------
# (a) the contributions
# ---------------------------------------------------------------------------

def test_chunk_contribs_match_reference(strict, shard_ranks, batch_ranks,
                                        port_runs):
    """Summed over partitions (``sharding.sum_partitions``), the aggregate
    and delta contributions equal the reference's bits.  (Asking for the
    gloo fixtures and the port's runs here starts the ranks early and runs
    the port while the reference runs.)"""
    x, d_x, delta = _contrib_inputs()
    yp = torch.from_numpy(x).reshape(4, 256)
    offs = torch.arange(4, dtype=torch.int32) * 256
    got = shd.sum_partitions(tpar.chunk_agg_contrib(
        yp, torch.from_numpy(_halos(yp.numpy(), 12)), offs, 1024, 12))
    assert _bits_equal(got.numpy(), strict()["agg/table"])
    yp = torch.from_numpy(d_x).reshape(4, 128)
    dp = torch.from_numpy(delta).reshape(4, 128)
    offs = torch.arange(4, dtype=torch.int32) * 128
    got = shd.sum_partitions(tpar.chunk_delta_contrib(
        yp, dp, torch.from_numpy(_halos(yp.numpy(), 8)),
        torch.from_numpy(_halos(dp.numpy(), 8)), offs, 512, 8))
    assert _bits_equal(got.numpy(), strict()["delta/table"])
    # one partition alone is the partition axis' row
    one = tpar.chunk_delta_contrib(yp[1], dp[1], yp[2, :8], dp[2, :8],
                                   128, 512, 8)
    full = tpar.chunk_delta_contrib(
        yp, dp, torch.from_numpy(_halos(yp.numpy(), 8)),
        torch.from_numpy(_halos(dp.numpy(), 8)), offs, 512, 8)
    assert torch.equal(one, full[1])


# ---------------------------------------------------------------------------
# (b) the global form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_compress_partitioned_matches_reference(case, strict, port_runs):
    got = port_runs[case]
    want = strict()
    for f in RESULT_FIELDS:
        assert _bits_equal(getattr(got, f).numpy(), want[f"{case}/{f}"]), f
    assert int(got.iters) > 10


def test_lockstep_partitioned_guarantee(port_runs):
    """``tests/test_parallel.py``'s property on the port: the deviation is
    within eps and equals a from-scratch re-measure of the decompressed
    series; the run compresses."""
    res = port_runs["uk"]
    cfg = _tcfg(**CASES["uk"][1])
    x = torch.from_numpy(_series(1024, seed=3))
    assert float(res.deviation) <= cfg.eps + 1e-12
    kept = res.kept.numpy()
    recon = tc.decompress(np.nonzero(kept)[0], res.xr.numpy()[kept], 1024,
                          device="cpu")
    dev_true = float(get_measure("mae")(t_acf(recon, 12), t_acf(x, 12)))
    assert abs(dev_true - float(res.deviation)) < 1e-8
    assert 1024 / int(res.n_kept) > 2.0
    assert res.kept[[0, 255, 256, 511, 512, 767, 768, 1023]].all()


def test_lockstep_telemetry(port_runs):
    """With telemetry on, the rounds record what the one probe a round
    read: every round accepted or rejected, the points the accepted rounds
    removed, the last accepted round and alpha a round; the result keeps
    its bits."""
    from repro_torch import obs
    spec, kw, T = CASES["uk"]
    was = obs.OBS.enabled
    obs.reset()
    obs.OBS.enabled = True
    try:
        res = tpar.compress_partitioned(_data(spec), _tcfg(**kw), T,
                                        device="cpu")
        snap = obs.snapshot()
    finally:
        obs.OBS.enabled = was
        obs.reset()
    for f in RESULT_FIELDS:
        assert torch.equal(getattr(res, f), getattr(port_runs["uk"], f)), f
    c = snap["counters"]
    iters = int(res.iters)
    assert c["partitioned.rounds_accepted"] \
        + c.get("partitioned.rounds_rejected", 0) == iters
    assert c["partitioned.points_removed"] == 1024 - int(res.n_kept)
    assert 0 <= snap["gauges"]["partitioned.last_accepted_round"] < iters
    alpha = snap["histograms"]["partitioned.alpha"]
    assert alpha["count"] == iters and alpha["max"] == kw.get("alpha", 0.1)


# ---------------------------------------------------------------------------
# (c) the local-budget variant
# ---------------------------------------------------------------------------

def test_compress_partitioned_local_matches_reference(strict):
    """The port's lanes are ``compress_batch``'s, each its solo run; the
    reference's are ``jax.vmap(compress_rounds)``, whose lanes round the
    interpolation otherwise than their solo runs (ROADMAP C11).  So every
    field equals the reference's merge of the partitions' solo runs bit
    for bit, and against its vmapped lanes the kept mask and iterations
    are equal, the reconstruction within one ulp (2.3e-16 here) and the
    deviation within 1e-12."""
    got = tpar.compress_partitioned_local(
        _series(1024, seed=4), _tcfg(eps=0.02, lags=12), 4, device="cpu")
    want = strict()
    for f in RESULT_FIELDS:
        assert _bits_equal(getattr(got, f).numpy(), want[f"solo/{f}"]), f
    for f in ("kept", "n_kept", "iters", "stat_orig"):
        assert _bits_equal(getattr(got, f).numpy(), want[f"local/{f}"]), f
    xr = want["local/xr"]
    np.testing.assert_allclose(got.xr.numpy(), xr, rtol=0,
                               atol=float(np.max(np.spacing(np.abs(xr)))))
    assert abs(float(got.deviation) - float(want["local/deviation"])) < 1e-12
    assert float(got.deviation) <= 0.02 + 1e-9


# ---------------------------------------------------------------------------
# (d) the shard form and compress_batch(mesh=) on gloo
# ---------------------------------------------------------------------------

def test_shard_form_gloo_equals_global(shard_ranks, port_runs):
    """Four gloo ranks, one partition each: every rank returns the global
    form's result in every field, bit for bit."""
    want = port_runs["uk"]
    for rank, got in shard_ranks().items():
        for f in RESULT_FIELDS:
            assert _bits_equal(got[f].numpy(), getattr(want, f).numpy()), \
                (rank, f)


def test_compress_batch_mesh_gloo_equals_unsharded(batch_ranks):
    """Two gloo ranks of two lanes each: the gathered batch equals the
    unsharded ``compress_batch`` bit for bit on both ranks; a batch of
    three raises the reference's error."""
    xs = np.stack([_series(512, seed=s) for s in range(4)])
    want = tc.compress_batch(xs, _tcfg(**BATCH), device="cpu")
    for rank, got in batch_ranks().items():
        for f in RESULT_FIELDS:
            assert _bits_equal(got[f].numpy(), getattr(want, f).numpy()), \
                (rank, f)
        assert got["uneven"] == ("batch 3 not divisible over 2 devices on "
                                 "axis 'data'")


# ---------------------------------------------------------------------------
# (e) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,T,kw", [
    (1000, 3, dict(lags=12)),                 # n % T
    (6912, 5, dict(lags=7, kappa=48)),        # T * kappa does not divide n
    (1024, 16, dict(lags=12)),                # my < L + W
])
def test_bad_plan_raises_as_reference(n, T, kw):
    x = _series(n)
    with pytest.raises(ValueError) as want:
        jpar._plan(JConfig(**kw), n, T)
    with pytest.raises(ValueError) as got:
        tpar.compress_partitioned(x, _tcfg(**kw), T, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tpar.compress_partitioned_local(np.zeros(1001), _tcfg(**kw), 4,
                                        device="cpu")


def test_entry_points_default_to_the_card():
    """Without ``device=`` the entry points run on the card and say so
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = _tcfg(eps=0.02, lags=12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.compress_partitioned(_series(1024), cfg, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.compress_partitioned_local(_series(1024), cfg, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.compress_batch(np.zeros((2, 256)), cfg)


def test_sharding_helpers_single_process(tmp_path):
    """The collective helpers on one gloo rank: halos from missing
    neighbours are zeros, a sum over one rank is the value + 0, counts
    pass through."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = shd.mesh_1d("cpu")
        assert (shd.axis_rank(mesh), shd.axis_size(mesh)) == (0, 1)
        t = torch.arange(1.0, 7.0).reshape(1, 6)
        assert torch.equal(shd.halo_from_next(t, 2, mesh), torch.zeros(1, 2))
        assert torch.equal(shd.halo_from_prev(t, 3, mesh), torch.zeros(1, 3))
        assert torch.equal(shd.sum_over_ranks(t, mesh), t)
        assert int(shd.count_over_ranks(torch.tensor(5), mesh)) == 5
        assert shd.mesh_device(mesh) == torch.device("cpu")
    finally:
        dist.destroy_process_group()


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
@pytest.mark.parametrize("case", list(CASES))
def test_gpu_partitioned_equals_cpu(cuda, case, port_runs):
    """The global form on the card (acf_window_impact, lag_dot's halo form
    on lanes, prefix_sum) equals its CPU run in every field."""
    spec, kw, T = CASES[case]
    got = tpar.compress_partitioned(_data(spec), _tcfg(**kw), T)
    for f in RESULT_FIELDS:
        assert torch.equal(getattr(got, f).cpu(),
                           getattr(port_runs[case], f)), f


@pytest.mark.gpu
def test_gpu_shard_form_and_mesh_nccl_world1(cuda, tmp_path):
    """On NCCL at world size 1: the shard form equals the global form of
    one partition, and ``compress_batch(mesh=)`` the unsharded batch."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = shd.mesh_1d("cuda")
        cfg = _tcfg(eps=0.02, lags=12)
        x = _series(1024, seed=3)
        got = tpar.compress_partitioned_shardmap(x, cfg, mesh)
        want = tpar.compress_partitioned(x, cfg, 1)
        for f in RESULT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        xs = np.stack([_series(512, seed=s) for s in range(4)])
        got = tc.compress_batch(xs, _tcfg(**BATCH), mesh=mesh)
        want = tc.compress_batch(xs, _tcfg(**BATCH))
        for f in RESULT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    finally:
        dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
