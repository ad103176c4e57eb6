"""The port's rounds-mode compressor against ``repro.core.cameo``.

(a) round by round: JAX runs k rounds, the carry crosses over
    (``repro_torch.convert``) and one port round is held against JAX's
    round k+1 — integer and bool fields exactly, float fields to 1e-10;
(b) end to end on the same corpus and on uk_elec at length 1024: kept and
    iters identical, deviation within 1e-12;
(c) one case each for the other measures, PACF, bisect, first_violation
    and target_cr;
(d) entry points refuse to fall back to the CPU silently;
(e) neither the port nor chip_smoke.py imports JAX or the JAX package;
plus a CPU rehearsal of chip_smoke.py's phases and, on a card, the main
path through the CUDA kernels.

Two compilations of the JAX reference appear here.  "jit" is the JAX
program as XLA compiles it by default.  XLA's CPU compiler changes
float32 values there: it rewrites ``num / sqrt(den)`` into ``num *
rsqrt(den)`` with an approximate rsqrt and contracts ``a*b - c*d`` into
fused multiply-adds, so its float32 ranking rows differ from the
op-by-op values by up to 4 ulp.  "strict" is the same JAX program
compiled with those rewrites off (``STRICT_XLA_FLAGS``, in subprocesses).
The port computes the op-by-op values, so it matches "strict" everywhere;
it matches "jit" except where a float32 ranking tie is closer than those
4 ulp (ROADMAP.md, section C, lists the cases; test_round_zero_kappa4
shows the first one).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cameo as jc
from repro.core.aggregates import interpolate_at as j_interpolate_at
from repro.data.synthetic import make_dataset
from repro.kernels import ref as j_ref
from repro_torch import convert
from repro_torch.core import cameo as tc
from repro_torch.core.aggregates import interpolate_at as t_interpolate_at
from repro_torch.kernels import ref as t_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)          # chip_smoke.py, at the repository root
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
FIELDS = ("xr", "alive", "prev", "nxt", "y", "tbl", "alpha", "dev", "rounds",
          "done", "blocked", "retried", "saw_c")
ROUND_CASES = [(rank, kappa) for rank in ("window", "single")
               for kappa in (1, 4)]
ROUND_KS = (0, 3, 10)


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (np.sin(2 * np.pi * t / 24) + 0.5 * np.sin(2 * np.pi * t / 168)
            + 0.15 * rng.standard_normal(n))


def _case(name):
    """(series, JAX config) of a named end-to-end case."""
    base = dict(eps=0.02, lags=12, backend="reference")
    if name == "uk_elec-1024":
        return (make_dataset("uk_elec", seed=0, length=1024),
                jc.CameoConfig(eps=1e-2, lags=24, backend="reference"))
    rank, _, kappa = name.partition("-k")
    if kappa:
        return _series(768, 4), jc.CameoConfig(rank=rank, kappa=int(kappa),
                                               **base)
    opt = {"rmse": dict(measure="rmse"), "cheb": dict(measure="cheb"),
           "pacf": dict(stat="pacf"), "bisect": dict(select="bisect"),
           "first_violation": dict(stop_policy="first_violation"),
           "target_cr": dict(target_cr=6.0)}[name]
    return _series(768, 4), jc.CameoConfig(**{**base, **opt})


# name -> the JAX compilation the port is held to end to end
E2E = {"window-k1": "jit", "window-k4": "strict", "single-k1": "jit",
       "single-k4": "strict", "uk_elec-1024": "strict"}
OPTIONS = {"rmse": "jit", "cheb": "strict", "pacf": "jit", "bisect": "jit",
           "first_violation": "jit", "target_cr": "jit"}


def _round_setup(rank, kappa):
    x = _series(768, 4)
    jcfg = jc.CameoConfig(eps=0.02, lags=12, rank=rank, kappa=kappa,
                          backend="reference")
    n = 768
    nb = jc._round_bucket(n, jcfg)
    min_alive, eps = jc._halting_params(n, jcfg)
    return x, jcfg, n, nb, min_alive, eps


def _jax_carries(rank, kappa, count):
    """JAX's carries after 0..count rounds (one jitted round at a time)."""
    x, jcfg, n, nb, min_alive, eps = _round_setup(rank, kappa)
    nv = jnp.asarray(n, jnp.int32)
    carry, p0 = jax.jit(lambda xp, nv: jc._rounds_init(xp, nv, jcfg))(
        jnp.pad(jnp.asarray(x), (0, nb - n)), nv)
    step = jax.jit(functools.partial(jc._rounds_chunk, cfg=jcfg, budget=1))
    out = [carry]
    for _ in range(count):
        carry, _ = step(carry, nv, jnp.asarray(min_alive, jnp.int32),
                        jnp.asarray(eps), p0)
        out.append(carry)
    return [[np.asarray(a) for a in c] for c in out], np.asarray(p0)


def _reference_main(out_path, jobs):
    """Subprocess entry: the JAX reference's results for ``jobs`` (end-to-end
    case names and ``rank-kappa`` round cases), saved as npz.  The caller
    picks the compilation through XLA_FLAGS (STRICT_XLA_FLAGS for
    "strict")."""
    jax.config.update("jax_enable_x64", True)
    res = {}
    for job in jobs:
        if job in E2E or job in OPTIONS:
            x, jcfg = _case(job)
            r = jc.compress_rounds(jnp.asarray(x), jcfg)
            res[f"{job}/kept"] = np.asarray(r.kept)
            res[f"{job}/iters"] = np.asarray(r.iters)
            res[f"{job}/deviation"] = np.asarray(r.deviation)
        else:
            rank, kappa = job.split("-")
            carries, p0 = _jax_carries(rank, int(kappa), max(ROUND_KS) + 1)
            res[f"{job}/p0"] = p0
            for k, c in enumerate(carries):
                for f, a in zip(FIELDS, c):
                    res[f"{job}/{k}/{f}"] = a
    np.savez(out_path, **res)


class _Reference:
    """One JAX compilation's reference results, computed by two
    subprocesses started at once, so the JAX compilations run side by side
    while the port's tests do."""

    def __init__(self, kind, tmp):
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        if kind == "strict":
            env["XLA_FLAGS"] = STRICT_XLA_FLAGS
        jobs = ([name for name, held_to in {**E2E, **OPTIONS}.items()
                 if held_to == kind]
                + [f"{rank}-{kappa}" for rank, kappa in ROUND_CASES])
        self.parts = []                   # (jobs, npz path, process)
        for i in range(2):
            out = tmp / f"{kind}{i}.npz"
            self.parts.append((jobs[i::2], out, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--reference",
                 str(out), *jobs[i::2]],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        self.data = {}

    def __call__(self, job):
        """The saved arrays of the part that computed ``job``."""
        jobs, out, proc = next(p for p in self.parts if job in p[0])
        if out not in self.data:
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log
            with np.load(out) as z:
                self.data[out] = {k: z[k] for k in z.files}
        return self.data[out]

    def carries(self, rank, kappa):
        key = f"{rank}-{kappa}"
        z = self(key)
        return ([[z[f"{key}/{k}/{f}"] for f in FIELDS]
                 for k in range(max(ROUND_KS) + 2)], z[f"{key}/p0"])

    def close(self):
        for _, _, proc in self.parts:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs tiny shapes here: more intra-op threads give no speed
    and only spin, starving the reference subprocesses and other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def refs(tmp_path_factory):
    """{"jit": ..., "strict": ...}: both JAX references, started before the
    module's first test."""
    tmp = tmp_path_factory.mktemp("jax_reference")
    out = {kind: _Reference(kind, tmp) for kind in ("jit", "strict")}
    yield out
    for r in out.values():
        r.close()


def port_round(rank, kappa, carry_np, p0):
    """One port round from a numpy carry; returns the numpy carry."""
    x, jcfg, n, nb, min_alive, eps = _round_setup(rank, kappa)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    probe, body = tc._round_fns(
        tcfg, nb, torch.tensor([n], dtype=torch.int32),
        torch.tensor([min_alive], dtype=torch.int32),
        torch.tensor([eps], dtype=torch.float64), torch.from_numpy(p0)[None])
    carry = convert.carry_from_numpy(carry_np, "cpu")
    ((go, small),) = probe(carry).tolist()
    assert go
    return convert.carry_to_numpy(body(carry, small=small))


def carry_mismatch(got, want):
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


def check_result(port, x, kept, iters, deviation):
    np.testing.assert_array_equal(port.kept.numpy(), np.asarray(kept))
    assert int(port.iters) == int(iters)
    assert abs(float(port.deviation) - float(deviation)) <= 1e-12


def check_invariant(res, x, tcfg):
    """Deviation <= eps, kept endpoints, kept values bit-exact, and the
    reported deviation equal to a from-scratch re-measure."""
    import chip_smoke
    kept, xr = res.kept.numpy(), res.xr.numpy()
    assert kept[0] and kept[-1]
    np.testing.assert_array_equal(xr[kept], x[kept])
    assert float(res.deviation) <= tcfg.eps + 1e-12 or tcfg.target_cr
    assert abs(chip_smoke.remeasure(x, xr, tcfg)
               - float(res.deviation)) <= 1e-9


# ---------------------------------------------------------------------------
# (d), (e): entry points and imports
# ---------------------------------------------------------------------------

def test_compress_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tc.CameoConfig(eps=0.05, lags=8)
    for call in (lambda: tc.compress(_series(256), cfg),
                 lambda: tc.compress_rounds(_series(256), cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_decompress_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx, vals = np.array([0, 5, 9]), np.array([1.0, -2.0, 3.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.decompress(idx, vals, 10)
    rec = tc.decompress(idx, vals, 10, device="cpu")
    assert rec.device.type == "cpu" and rec.shape == (10,)


def test_unported_surfaces_raise(tmp_path):
    """What was not ported runs now: the sequential mode, select="scan",
    compress_batch on one device and over a device mesh (one gloo rank,
    equal to the unsharded batch; ``tests/test_torch_parallel.py`` holds
    more ranks)."""
    import torch.distributed as dist
    from repro_torch import sharding
    x = _series(128)
    for cfg in (tc.CameoConfig(mode="sequential", lags=8),
                tc.CameoConfig(select="scan", lags=8)):
        res = tc.compress(x, cfg, device="cpu")
        assert res.kept.shape == (128,) and bool(res.kept[0] & res.kept[-1])
    res = tc.compress_batch(np.stack([x, x]), tc.CameoConfig(lags=8),
                            device="cpu")
    assert res.kept.shape == (2, 128) and bool(res.kept[:, [0, -1]].all())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        got = tc.compress_batch(np.stack([x, x]), tc.CameoConfig(lags=8),
                                mesh=sharding.mesh_1d("cpu"))
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, res):
        assert torch.equal(a, b)


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port (walked with ``pkgutil``, so later modules
    are covered too) and chip_smoke.py import no JAX and nothing of the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert 'repro_torch.baselines.line_simpl' in mods, mods\n"
        "import chip_smoke\n"
        "from chip_smoke import run_phases, remeasure\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(mods), 'ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    n, ok = out.stdout.split()
    assert ok == "ok" and int(n) > 40, out.stdout


def test_config_and_carry_convert():
    jcfg = jc.CameoConfig(eps=0.03, lags=7, kappa=4, backend="pallas",
                          target_cr=3.0)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.backend == "cuda" and tcfg.kappa == 4 and tcfg.lags == 7
    assert dataclasses.asdict(tcfg) == {**dataclasses.asdict(jcfg),
                                        "backend": "cuda"}
    carry, _ = tc._rounds_init(torch.from_numpy(_series(64))[None],
                               torch.tensor([60], dtype=torch.int32),
                               dataclasses.replace(tcfg, backend="reference"))
    arrays = convert.carry_to_numpy(carry)
    back = convert.carry_to_numpy(convert.carry_from_numpy(arrays, "cpu"))
    assert [a.dtype for a in arrays] == [
        np.float64, np.bool_, np.int32, np.int32, np.float64, np.float64,
        np.float64, np.float64, np.int32, np.bool_, np.bool_, np.bool_,
        np.bool_]
    assert arrays[0].shape == (64,) and arrays[5].shape == (5, 7)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a batched carry crosses with its lane axis
    lanes = convert.carry_to_numpy(carry, batched=True)
    assert lanes[0].shape == (1, 64) and lanes[8].shape == (1,)
    again = convert.carry_from_numpy(lanes, "cpu", batched=True)
    for a, b in zip(carry, again):
        assert torch.equal(a, b)


def test_kept_points_decompress_roundtrip():
    x = _series(300, 2)
    res = tc.compress(x, tc.CameoConfig(eps=0.05, lags=8), device="cpu")
    idx, vals = tc.kept_points(res)
    rec = tc.decompress(idx, vals, 300, device="cpu")
    np.testing.assert_allclose(rec.numpy(), res.xr.numpy(), rtol=0,
                               atol=1e-12)
    want = np.asarray(jc.decompress(idx, vals, 300))
    np.testing.assert_allclose(rec.numpy(), want, rtol=0, atol=1e-12)
    assert tc.compression_ratio(res) == 300 / len(idx)


def test_chip_smoke_phases_rehearsal():
    """chip_smoke.py's phases 3-4, and tools/profile_paths.py's divergence
    pass, at a tiny size on the CPU, where every wrapper takes its plain
    version (the script itself refuses to run without a card)."""
    import chip_smoke
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_paths
    report = chip_smoke.run_phases(
        "cpu", uk_length=512, aus_length=48 * 48,
        seq_lengths={"uk_elec": 256, "aus_elec": 48 * 12},
        batches=(("uk_elec", 3, True), ("aus_elec", 2, True),
                 ("uk_elec", 4, False)),
        kernel_lanes={"uk_elec": 3, "aus_elec": 2}, prefix_lanes=2,
        mv_columns=2,
        streams=(("uk_elec", "uk_elec", 1200, 256, (1, 3), True),
                 ("aus_elec", "aus_elec", 2000, 480, (1, 2), False)),
        stream_mv=(2, 900, 256), log=lambda s: None)
    # prefix_sum's one row and pair of rows (and, with uk_elec, its pairs
    # of four more lengths); the window kernels: the main cases (with
    # acf_window_impact's partitioned ranking chunk), then a boundary-heavy
    # one each; segment_cells' tiers, lanes and float32 (after cell_sum's,
    # at aus_elec's kappa 48), then with uk_elec dense_sxx at min_temp's 365
    # lags; then the five kernels of the rounds path on lanes (prefix_devs
    # at uk_elec only)
    assert [(k["dataset"], k["name"]) for k in report["kernels"]] == [
        (d if k != "dense_sxx 365" else "min_temp", k.split()[0])
        for d in ("uk_elec", "aus_elec")
        for k in ("lag_dot",) + ("prefix_sum",) * (6 if d == "uk_elec" else 2)
        + ("dense_sxx", "acf_impact", "window_rows", "window_rows")
        + ("acf_window_impact",) * 3
        + ("acf_impact", "prefix_devs", "prefix_devs")
        + (("segment_cells",) * 3 + ("dense_sxx 365",) if d == "uk_elec"
           else ("cell_sum",) * 3 + ("segment_cells",) * 3)
        ] + [
        (d, k) for d in ("uk_elec", "aus_elec")
        for k in ("lag_dot", "prefix_sum", "dense_sxx", "acf_impact",
                  "window_rows") + (("prefix_devs",) if d == "uk_elec"
                                    else ())]
    assert [k["lanes"] for k in report["kernels"] if "lanes" in k] == \
        [3] * 5 + [2] * 6
    assert all(k["max_abs_err"] == 0.0 for k in report["kernels"])
    edge = [k for k in report["kernels"] if "boundary-heavy" in k["shape"]]
    assert [k["name"] for k in edge] == ["window_rows",
                                         "acf_window_impact"] * 2
    assert all("interior=" in k["shape"] for k in edge)
    assert report["launch_floor_ms"] is None
    # prefix_devs: a random walk, then the scan's real round 3 (the card's
    # greedy branch, dispatched as on the card)
    pd = [k for k in report["kernels"] if k["name"] == "prefix_devs"
          and "lanes" not in k]
    assert [k["shape"].split(":")[0] for k in pd] == ["random",
                                                      "real round 3"] * 2
    assert all(0 < k["ok"] <= k["K"] and k["interior"] <= k["ok"]
               for k in pd)
    # segment_scan's holds come with the baselines phase, after run_phases
    names = [n for n in chip_smoke.WRAPPERS if n != "segment_scan"]
    rows = chip_smoke.kernel_rows(report, names)
    assert [r["name"] for r in rows] == names
    with pytest.raises(chip_smoke.SmokeFailure, match="segment_scan"):
        chip_smoke.kernel_rows(report)
    assert [len(r["shapes"]) for r in rows] == [4, 6, 6, 6, 5, 10, 5, 3, 6]
    ps = [k for k in report["kernels"] if k["name"] == "prefix_sum"]
    assert [k["shape"].split(" x n=")[1] for k in ps[2:6]] == [
        f"{n} float64" for n in chip_smoke.PREFIX_SUM_LENGTHS]
    # the batch phase: each lane held against its per-series run, and the
    # multivariate run's columns on one shared index
    bt = report["batches"]
    assert [(r["path"], r["dataset"], r.get("B")) for r in bt] == [
        ("batch", "uk_elec", 3), ("batch", "aus_elec", 2),
        ("batch", "uk_elec", 4), ("multivariate", "uk_elec", None)]
    assert [r.get("lanes_held") for r in bt[:3]] == [3, 2, None]
    assert bt[3]["C"] == 2 and len(bt[3]["deviations"]) == 2
    div = profile_paths.first_divergence("cpu", length=48 * 48)
    assert div["parted"] is None and div["init"] == {}
    assert div["lockstep_rounds_differing"] == 0
    assert div["rounds_cpu"] == report["runs"][1]["iters"]
    assert [(r["dataset"], r["path"]) for r in report["runs"]] == [
        (d, p) for p in ("rounds", "scan", "sequential")
        for d in ("uk_elec", "aus_elec")]
    assert report["launches"] == dict.fromkeys(chip_smoke.WRAPPERS, 0)
    # the streaming phase: both streams and the multivariate one held, the
    # aus_elec tail (80 points, one target point) kept verbatim
    st = report["streams"]
    assert [r["case"] for r in st["rows"]] == ["uk_elec", "aus_elec",
                                               "multivariate"]
    uk, aus = st["rows"][:2]
    assert uk["windows"] == 5 and uk["full_windows"] == 4
    assert uk["tail"] == 1200 - 4 * 256 and uk["tail_iters"] > 0
    assert aus["tail"] == 80 and aus["tail_iters"] == 0
    assert set(uk["depths"]) == {"1", "3"}
    assert uk["depths"]["3"]["batch_calls"] >= 1
    assert uk["depths"]["1"]["batch_calls"] == 0
    assert st["counters"]["stream.windows"] > 0
    json.dumps(report)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# (a) round by round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["jit", "strict"])
@pytest.mark.parametrize("k", ROUND_KS)
@pytest.mark.parametrize("rank,kappa", ROUND_CASES)
def test_round_matches_reference(rank, kappa, k, kind, refs):
    carries, p0 = refs[kind].carries(rank, kappa)
    got = port_round(rank, kappa, carries[k], p0)
    bad = carry_mismatch(got, carries[k + 1])
    # round 0 at kappa = 4 parts from "jit" at a float32 near-tie
    # (test_round_zero_kappa4_is_float32_near_tie); "strict" holds it exactly
    assert not bad or (kind, kappa, k) == ("jit", 4, 0), bad


def test_round_zero_kappa4_is_float32_near_tie(refs):
    """Round 0 at kappa = 4 (seed 4, n = 768, L = 12): every span is 1, so
    the ranking is the Eq. 8 float32 pass alone.  XLA's fused rows differ
    from the port's (op-by-op) rows by at most 4 ulp, and the two rank
    orders first part at a pair whose impact gap is within that noise."""
    carries, p0 = refs["jit"].carries("window", 4)
    xr, alive, prev, nxt, y, tbl = carries[0][:6]
    kappa, n, nb = 4, 768, xr.shape[0]
    ny = jnp.asarray(n // kappa, jnp.int32)
    idx = np.arange(nb, dtype=np.int32)

    @jax.jit
    def jax_rows(xr, prev, nxt, y, tbl):
        dx = j_interpolate_at(xr, prev, nxt, jnp.asarray(idx)) - xr
        dval = (dx / jnp.asarray(kappa, jnp.float64)).astype(jnp.float32)
        return j_ref.acf_after_single_delta(
            tbl.astype(jnp.float32), y.astype(jnp.float32),
            jnp.asarray(idx) // kappa, dval, ny=ny)

    rows_j = np.asarray(jax_rows(xr, prev, nxt, y, tbl))
    T = torch.from_numpy
    dx = t_interpolate_at(T(xr), T(prev), T(nxt), T(idx)) - T(xr)
    rows_t = t_ref.acf_after_single_delta(
        T(tbl).float(), T(y).float(), T(idx) // kappa,
        (dx / kappa).float(), ny=torch.tensor(n // kappa)).numpy()
    ulp = np.spacing(np.abs(rows_t))
    assert np.max(np.abs(rows_j - rows_t) / ulp) <= 4
    p0r = p0.astype(np.float32)
    keys_j = np.mean(np.abs(rows_j - p0r), axis=1)
    keys_t = np.mean(np.abs(rows_t - p0r), axis=1)
    noise = float(np.max(np.abs(keys_j - keys_t)))
    assert noise <= 4 * float(np.max(ulp))
    cand = alive & (idx > 0) & (idx < n - 1)
    order_j = np.argsort(np.where(cand, keys_j, np.inf), kind="stable")
    order_t = np.argsort(np.where(cand, keys_t, np.inf), kind="stable")
    first = int(np.argmax(order_j != order_t))
    assert order_j[first] != order_t[first]
    a, b = order_j[first], order_t[first]
    assert abs(float(keys_t[a]) - float(keys_t[b])) <= 2 * noise


# ---------------------------------------------------------------------------
# (b), (c) end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(E2E) + list(OPTIONS))
def test_end_to_end(name, refs):
    x, jcfg = _case(name)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    port = tc.compress_rounds(x, tcfg, device="cpu")
    check_invariant(port, x, tcfg)
    z = refs[{**E2E, **OPTIONS}[name]](name)
    check_result(port, x, z[f"{name}/kept"], z[f"{name}/iters"],
                 z[f"{name}/deviation"])


# ---------------------------------------------------------------------------
# the main path on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_main_path(cuda):
    from repro_torch.kernels import acf_impact, dense_sxx, fused_round, lag_dot
    wrappers = (lag_dot.lag_dot_cuda, acf_impact.acf_impact_cuda,
                fused_round.window_rows_cuda, dense_sxx.dense_sxx_cuda)
    x = make_dataset("uk_elec", seed=0, length=4096)
    cfg = tc.CameoConfig(eps=1e-2, lags=48)
    before = [w.launches for w in wrappers]
    res = tc.compress(x, cfg)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    res = tc.CompressResult(*(t.cpu() for t in res))
    check_invariant(res, x, cfg)
    cpu = tc.compress(x, cfg, device="cpu")
    cr, cr_cpu = 4096 / float(res.n_kept), 4096 / float(cpu.n_kept)
    assert abs(cr - cr_cpu) <= 0.05 * cr_cpu


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_main(sys.argv[2], sys.argv[3:])
