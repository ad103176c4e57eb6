"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), and the port's counters on its entry points.

(a) the same call sequence gives equal snapshots and byte-equal
    Prometheus exposition in both registries (counters, labeled series,
    gauges, histograms; tolerance 0: the two are the same stdlib code);
(b) span nesting through the JSONL sink: the same events (name, depth,
    parent, attrs, error) in both packages;
(c) the ``profile`` bracket runs ``torch.profiler`` around the region,
    writes a trace and never raises (an already-active profiler included);
(d) the recompile watermark: ``register_jit`` keeps its API (any object
    with ``_cache_size()``), and the port registers its kernel builder as
    ``kernels.build``, whose count is the ``nvcc`` builds of the process
    (0 on the CPU: nothing is built);
(e) ``compress_batch`` and ``compress_multivariate`` record the JAX
    package's ``cameo.batch_rounds_total`` and ``mvar.*`` metrics under the
    same names, with equal values where the two drivers agree (the rounds
    of equal runs, the ε headroom of each column to 1e-9);
    ``cameo.batch_lane_occupancy`` is the port driver's own measure.  The
    multivariate cases are held to JAX compiled without XLA's float
    rewrites (in a subprocess), as ``tests/test_torch_batch.py`` holds
    them: the default compilation parts from both at float32 near-ties
    (ROADMAP C7).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.core import cameo as jc
from repro_torch.core import cameo as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
CFG = dict(eps=2e-2, lags=8, mode="rounds", max_rounds=60, dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def both_obs():
    """Both process-wide registries reset and enabled; restored after."""
    saved = []
    for mod in (jobs, tobs):
        saved.append((mod.enabled(), list(mod.OBS._sinks)))
        mod.reset()
        mod.enable()
    yield jobs, tobs
    for mod, (was, sinks) in zip((jobs, tobs), saved):
        mod.OBS._sinks[:] = sinks
        mod.reset()
        mod.OBS.enabled = was


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (3 * np.sin(2 * np.pi * t / 24) + np.sin(2 * np.pi * t / 168)
            + 0.2 * rng.standard_normal(n))


def _drive(reg):
    """One fixed call sequence over every metric kind."""
    rng = np.random.default_rng(7)
    for v in rng.lognormal(-3, 2, 500):
        reg.observe("stream.push_seconds", float(v))
    reg.observe("h.zero", 0.0)
    reg.observe("h.neg", -2.5)
    reg.inc("stream.windows", 3)
    reg.inc("stream.windows")
    reg.inc("a.b", 2, labels={"tenant": "t0"})
    reg.inc("a.b", 1, labels={"tenant": "t1", "shard": 's"x\\y'})
    reg.inc("a.b.c", 5)
    reg.gauge("stream.queue_depth", 4)
    reg.gauge("g", 1.5, labels={"shard": "s1"})
    reg.observe("h", 1.0, labels={"tenant": "t0"})
    reg.gauge("nan", float("nan"))


def test_registry_snapshot_and_exposition_equal():
    a = jobs.MetricsRegistry(enabled=True)
    b = tobs.MetricsRegistry(enabled=True)
    _drive(a)
    _drive(b)
    sa, sb = a.snapshot(), b.snapshot()
    assert json.dumps(sa, sort_keys=True) == json.dumps(sb, sort_keys=True)
    assert a.exposition() == b.exposition()
    assert a.exposition("x") == b.exposition("x")
    for name in ("stream.push_seconds", "h.neg", "h.zero"):
        assert sa["histograms"][name] == sb["histograms"][name]
    assert (jobs.sanitize_metric_name("a.b-c/d{x}")
            == tobs.sanitize_metric_name("a.b-c/d{x}"))


def test_module_api_equal(both_obs):
    for mod in both_obs:
        mod.inc("c", 2)
        mod.gauge("g", 3)
        mod.observe("h", 0.25)
        with mod.span("outer", sid="s"):
            with mod.span("inner"):
                pass
    snaps = [mod.snapshot() for mod in both_obs]
    for s in snaps:    # span timings differ; their counts do not
        for k in ("span.outer.seconds", "span.inner.seconds"):
            assert s["histograms"].pop(k)["count"] == 1
        s.pop("recompiles", None)
    assert snaps[0] == snaps[1]


def test_span_nesting_jsonl(both_obs, tmp_path):
    events = []
    for mod in both_obs:
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        mod.OBS._sinks[:] = [mod.jsonl_sink(path)]
        with mod.span("outer", sid="s1"):
            assert mod.current_span().name == "outer"
            with mod.span("inner") as sp:
                sp.set("rows", 7)
                assert sp.depth == 1 and sp.parent == "outer"
        with pytest.raises(ValueError):
            with mod.span("boom"):
                raise ValueError("x")
        mod.event("checkpoint", step=3)
        evs = [json.loads(line) for line in open(path)]
        assert all(e.pop("ts") > 0 for e in evs)
        for e in evs:
            assert e.pop("dur_s", 0.0) >= 0
        events.append(evs)
    assert events[0] == events[1]
    by_name = {e.get("name", e.get("ev")): e for e in events[1]}
    assert by_name["inner"]["depth"] == 1
    assert by_name["inner"]["parent"] == "outer"
    assert by_name["inner"]["attrs"] == {"rows": 7}
    assert by_name["boom"]["error"] == "ValueError"
    assert not tobs.enabled() or tobs.span("x") is not tobs.NULL_SPAN
    tobs.disable()
    assert tobs.span("x") is tobs.NULL_SPAN


def test_profile_bracket_traces_and_never_raises(tmp_path):
    logdir = str(tmp_path / "prof")
    with tobs.profile(logdir) as d:
        assert d == logdir
        torch.ones(64).cumsum(0)
        # a second bracket inside the first cannot start a profiler: the
        # region runs untraced, and nothing raises
        with tobs.profile(str(tmp_path / "inner")) as d2:
            torch.ones(8).sum()
        assert d2 == str(tmp_path / "inner")
    traces = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert traces, os.listdir(logdir)
    with open(os.path.join(logdir, traces[0])) as f:
        assert "traceEvents" in json.load(f)
    import repro_torch.obs.trace as trace
    assert "jax" not in trace.profile.__doc__


def test_register_jit_and_build_watermark():
    from repro_torch.kernels import _build
    reg = tobs.MetricsRegistry(enabled=True)
    with pytest.raises(TypeError, match="_cache_size"):
        reg.register_jit("plain", lambda: None)

    class Counter:
        n = 2

        def _cache_size(self):
            return self.n

    c = Counter()
    reg.register_jit("x", c)
    assert reg.recompile_counts() == {"x": 2}
    assert reg.recompile_watermark() == 2
    c.n = 5
    assert reg.recompile_watermark() == 5
    assert "cameo_recompile_watermark 5" in reg.exposition()
    # the port's one registered entry: its kernel builder
    counts = tobs.recompile_counts()
    assert counts["kernels.build"] == _build._BUILDER.built
    if not torch.cuda.is_available():
        assert counts["kernels.build"] == 0
    before = tobs.recompile_watermark()
    tc.compress(_series(256), tc.CameoConfig(**CFG), device="cpu")
    assert tobs.recompile_watermark() == before


def test_compress_batch_counters(both_obs):
    xs = np.stack([_series(384, s) for s in range(3)])
    want = jc.compress_batch(jnp.asarray(xs), jc.CameoConfig(**CFG))
    got = tc.compress_batch(xs, tc.CameoConfig(**CFG), device="cpu")
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    sj, st = jobs.snapshot(), tobs.snapshot()
    assert (st["counters"]["cameo.batch_rounds_total"]
            == sj["counters"]["cameo.batch_rounds_total"]
            == int(np.asarray(want.iters).sum()))
    occ = st["gauges"]["cameo.batch_lane_occupancy"]
    assert 0.0 < occ <= 1.0
    # compress_rounds is one lane of the same driver but records nothing
    tobs.reset()
    tc.compress_rounds(xs[0], tc.CameoConfig(**CFG), device="cpu")
    assert "cameo.batch_rounds_total" not in tobs.snapshot()["counters"]


def _mv_case(seed=0, n=768, eps=3e-3):
    """Two columns whose first pass misses a tight budget, so the repair
    loop halves it (and, for seed 0, keeps a column whole)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    base = 3 * np.sin(2 * np.pi * t / 24) + np.sin(2 * np.pi * t / 168)
    X = np.stack([base + 0.2 * rng.standard_normal(n),
                  0.5 * base + 1 + 0.15 * rng.standard_normal(n)], 1)
    return X, dict(CFG, eps=eps)


def _reference(out_path):
    """JAX's compress_multivariate with telemetry on, compiled without
    XLA's float rewrites (the compilation the port is held to, ROADMAP C1
    and C7): its deviations and registry snapshot, as JSON."""
    jobs.enable()
    out = {}
    for seed in (0, 1):
        jobs.reset()
        X, cfg = _mv_case(seed)
        r = jc.compress_multivariate(X, jc.CameoConfig(**cfg), max_retries=1)
        out[seed] = dict(kept=np.asarray(r.kept).tolist(),
                         deviations=np.asarray(r.deviations).tolist(),
                         snapshot=jobs.snapshot())
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def mv_strict(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_strict") / "mv.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_multivariate_counters(both_obs, mv_strict, seed):
    X, cfg = _mv_case(seed)
    got = tc.compress_multivariate(X, tc.CameoConfig(**cfg), max_retries=1,
                                   device="cpu")
    want = mv_strict[str(seed)]
    np.testing.assert_array_equal(got.kept, np.asarray(want["kept"]))
    np.testing.assert_allclose(got.deviations, want["deviations"], rtol=0,
                               atol=1e-12)
    sj, st = want["snapshot"], tobs.snapshot()
    assert st["counters"].get("mvar.repair_halvings", 0) >= 1
    for name in ("mvar.repair_halvings", "mvar.keep_all_columns",
                 "cameo.batch_rounds_total"):
        assert st["counters"].get(name) == sj["counters"].get(name), name
    hj, ht = (s["histograms"]["mvar.eps_headroom"] for s in (sj, st))
    assert hj["count"] == ht["count"] == X.shape[1]
    for k in ("sum", "min", "max"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=1e-9)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        import jax
        jax.config.update("jax_enable_x64", True)
        _reference(sys.argv[2])
