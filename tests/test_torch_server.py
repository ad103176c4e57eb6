"""The port's multi-tenant ingest server (``repro_torch.server``) against
the JAX package's (``repro.server``), and its own contracts.

The JAX side runs in a subprocess compiled without XLA's float rewrites
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``,
the compilation the port is held to, ROADMAP C1/C10).  Held:
(a) the same server calls give the same file bytes: tenant registration
    (the footer's tenant table), sessions of three tenants sealing small
    blocks, a one-shot ``write`` and ``write_batch`` through a tenant's
    view, synchronous compaction, and a session closed under
    ``auto_compact`` with the background worker drained;
(b) a crash image of a server with two open sessions is the same bytes in
    both packages, and either package's ``resume=True`` server replays the
    other's journal to the same final file;
(c) a compaction of a JAX-written file is the first thing a port server
    does (no compression before it in the process): the same bytes as
    JAX's compaction;
(d) the concurrency contract, quotas (refused before the journal),
    ``backpressure="reject"``, duplicate sessions, ``stats()`` and the
    ``/metrics`` exposition, on the port alone;
(e) the server's default device (the card: without one it raises) and,
    on a card only, four producer threads against the same sessions run
    one after another, and a compaction racing the first kernel build.
"""
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
CFG = dict(eps=2e-2, lags=8, mode="rounds", max_rounds=60, dtype="float64")
W = 64            # stream window
SEAL = 64         # small sealed blocks
BLK = 256         # full-size blocks (compaction target)
CHUNK = 37
N = 1100
CUT = 600         # points each session acked before the crash


def _series(n=N, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (3 * np.sin(2 * np.pi * t / 24 + seed)
            + 0.2 * rng.standard_normal(n))


def _package(which):
    if which == "jax":
        from repro import server
        from repro.core import cameo
        kw = {}
    else:
        from repro_torch import server
        from repro_torch.core import cameo
        kw = dict(device="cpu")
    return types.SimpleNamespace(name=which, server=server, kw=kw,
                                 cfg=cameo.CameoConfig(**CFG))


def _scfg(pk, **kw):
    base = dict(block_len=BLK, seal_block_len=SEAL, stream_window=W,
                auto_compact=False)
    base.update(kw)
    return pk.server.ServerConfig(**base)


def _server(pk, path, resume=False, **kw):
    return pk.server.IngestServer(path, pk.cfg, _scfg(pk, **kw),
                                  resume=resume, **pk.kw)


def _feed(sess, x, a=0, b=None):
    b = len(x) if b is None else b
    for i in range(a, b, CHUNK):
        sess.push(x[i:min(i + CHUNK, b)])


def _snapshot_crash(store, p):
    store._f.flush()
    if store._wal is not None:
        store._wal._f.flush()
    shutil.copyfile(store.path, p)
    if store._wal is not None:
        shutil.copyfile(store._wal.path, p + ".wal")


def _serve_all(pk, d):
    """Every server scenario of one package into directory ``d``."""
    srv = _server(pk, os.path.join(d, "tenants.cameo"))
    srv.register_tenant("acme", eps=5e-2, max_points=10 ** 6)
    srv.register_tenant("b")
    for i, (tenant, series) in enumerate((("", "s"), ("acme", "s"),
                                          ("b", "t"))):
        with srv.session(series, tenant=tenant) as sess:
            _feed(sess, _series(seed=i))
    srv.view("acme").write("one", _series(512, seed=5))
    # one series a length: solo compressions (JAX's batch lanes round the
    # deviation otherwise than its solo runs, ROADMAP C11)
    srv.view("b").write_batch({"u": _series(256, seed=6),
                               "v": _series(320, seed=7)})
    srv.compact("s")
    srv.compact("s", tenant="acme")
    srv.close()
    # the background worker
    srv = _server(pk, os.path.join(d, "bg.cameo"), auto_compact=True)
    srv.register_tenant("a")
    with srv.session("s", tenant="a") as sess:
        _feed(sess, _series(seed=9))
    srv.drain_compaction()
    srv.close()
    # a crash with two sessions open
    live = os.path.join(d, "live.cameo")
    srv = _server(pk, live)
    sessions = {}
    for i, t in enumerate(("a", "b")):
        srv.register_tenant(t)
        sessions[t] = srv.session("s", tenant=t)
    for i, t in enumerate(("a", "b")):
        _feed(sessions[t], _series(seed=3 + i), 0, CUT)
    _snapshot_crash(srv.store, os.path.join(d, "crash.cameo"))
    for sess in sessions.values():
        sess.close()
    srv.close()
    # a small-block series for (c), not yet compacted
    srv = _server(pk, os.path.join(d, "precompact.cameo"))
    with srv.session("s") as sess:
        _feed(sess, _series(seed=11))
    srv.close()


def _finish_crash(pk, path):
    """Resume both sessions of a crash image and feed the rest."""
    srv = _server(pk, path, resume=True)
    starts = []
    for i, t in enumerate(("a", "b")):
        sess = srv.session("s", tenant=t, resume=True)
        starts.append(sess.resume_from)
        _feed(sess, _series(seed=3 + i), sess.resume_from)
        sess.close()
    srv.close()
    return starts


def _compact_first(pk, path):
    """Open a finished small-block file and compact it, first thing."""
    srv = _server(pk, path, resume=True)
    rep = srv.compact("s")
    srv.close()
    return rep


FILES = ("tenants", "bg", "crash", "precompact")


def _copy(src_dir, dst_dir, names):
    os.makedirs(dst_dir)
    for name in names:
        for suffix in ("", ".wal"):
            p = os.path.join(src_dir, f"{name}.cameo{suffix}")
            if os.path.exists(p):
                shutil.copyfile(p, os.path.join(dst_dir,
                                                f"{name}.cameo{suffix}"))


def _reference(out):
    """The JAX side: its own scenarios, then (in copies) its finishing of
    the port's crash image and its compaction of its own small-block
    file."""
    pk = _package("jax")
    jdir, pdir = os.path.join(out, "jax"), os.path.join(out, "port")
    _serve_all(pk, jdir)
    _copy(pdir, os.path.join(out, "jax_finishes_port"), ["crash"])
    _copy(jdir, os.path.join(out, "port_finishes_jax"), ["crash"])
    _copy(jdir, os.path.join(out, "jax_compacted"), ["precompact"])
    _copy(jdir, os.path.join(out, "port_compacts_jax"), ["precompact"])
    starts = _finish_crash(pk, os.path.join(out, "jax_finishes_port",
                                            "crash.cameo"))
    _finish_crash(pk, os.path.join(jdir, "crash.cameo"))
    rep = _compact_first(pk, os.path.join(out, "jax_compacted",
                                          "precompact.cameo"))
    np.savez(os.path.join(out, "jax.npz"), starts=np.asarray(starts),
             runs=np.asarray(rep["runs"]))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def files(tmp_path_factory, one_torch_thread):
    out = str(tmp_path_factory.mktemp("server_xpkg"))
    for sub in ("port", "jax"):
        os.makedirs(os.path.join(out, sub))
    _serve_all(_package("torch"), os.path.join(out, "port"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", out],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


@pytest.mark.parametrize("name", FILES)
def test_same_calls_same_bytes(files, name):
    """Registration, sessions, view writes, compaction (synchronous and
    in the background), a crash image with open sessions and a
    small-block file: the same bytes, journals included."""
    for suffix in ("", ".wal"):
        p = os.path.join(files, "port", f"{name}.cameo{suffix}")
        j = os.path.join(files, "jax", f"{name}.cameo{suffix}")
        if name == "crash":       # JAX's image was finished in place
            j = os.path.join(files, "port_finishes_jax",
                             f"{name}.cameo{suffix}")
        assert os.path.exists(p) == os.path.exists(j), suffix
        if os.path.exists(p):
            assert _bytes(p) == _bytes(j), name + suffix


def test_crash_replays_across_packages(files):
    """Each package's resumed server replays the other's journal: every
    acked push is recovered and the finished files are the same bytes,
    whoever wrote the image and whoever finished it."""
    pk = _package("torch")
    with np.load(os.path.join(files, "jax.npz")) as z:
        assert list(z["starts"]) == [CUT, CUT]
    want = _bytes(os.path.join(files, "jax", "crash.cameo"))
    assert _bytes(os.path.join(files, "jax_finishes_port",
                               "crash.cameo")) == want
    for sub in ("port", "port_finishes_jax"):
        path = os.path.join(files, sub, "crash.cameo")
        assert _finish_crash(pk, path) == [CUT, CUT]
        assert _bytes(path) == want, sub


def test_compaction_first_equals_jax(files):
    """A port server whose first act is a compaction of JAX's small-block
    file writes JAX's compacted bytes."""
    pk = _package("torch")
    path = os.path.join(files, "port_compacts_jax", "precompact.cameo")
    rep = _compact_first(pk, path)
    with np.load(os.path.join(files, "jax.npz")) as z:
        assert rep["runs"] == int(z["runs"]) > 0
    assert _bytes(path) == _bytes(os.path.join(files, "jax_compacted",
                                               "precompact.cameo"))


def test_tenant_table_and_reads(files):
    """The tenant table and the tenants' series read back the same from
    either package's file."""
    pk = _package("torch")
    out = []
    for sub in ("port", "jax"):
        srv = _server(pk, os.path.join(files, sub, "tenants.cameo"),
                      resume=True)
        out.append((srv.catalog.tenants(), srv.catalog.config("acme"),
                    srv.catalog.series_of(""), srv.view("b").sids(),
                    srv.catalog.usage("acme"),
                    srv.view("acme").series("s").window().tobytes(),
                    srv.view("acme").series("s").mean(100, 900)))
        srv.close()
    assert out[0][:5] == out[1][:5]
    assert out[0][0] == ["acme", "b"] and out[0][2] == ["s"]
    assert out[0][1] == {"eps": 5e-2, "max_points": 10 ** 6}
    assert out[0][5] == out[1][5]
    assert [np.asarray(v).tobytes() for v in out[0][6]] == \
        [np.asarray(v).tobytes() for v in out[1][6]]


# ---------------------------------------------------------------------------
# (d) the port's own contracts
# ---------------------------------------------------------------------------

def _bodies(store, sid):
    entry = store._series[sid]
    bodies = [bytes(b) for b in store._read_bodies(entry["blocks"])]
    facts = [(b["nbytes"], b["t0"], b["t1"]) for b in entry["blocks"]]
    return bodies, facts


def _entry_key(store, sid):
    e = store.series_meta(sid)
    return {k: e[k] for k in ("n", "n_kept", "eps", "stored_nbytes",
                              "payload_nbytes", "deviation")}


def _concurrent_matches_serial(tmp_path, device, n):
    """Four producer threads into one server, against the same sessions
    run one after another: per-series bodies and entries equal, before and
    after compaction."""
    from repro_torch.server import IngestServer, ServerConfig, tenant_sid
    from repro_torch.core.cameo import CameoConfig
    cfg = CameoConfig(**CFG)
    scfg = dict(block_len=BLK, seal_block_len=SEAL, stream_window=W,
                auto_compact=False)
    tenants = [f"t{i}" for i in range(4)]
    feeds = {t: _series(n, seed=i) for i, t in enumerate(tenants)}
    ref = IngestServer(str(tmp_path / "serial.cameo"), cfg,
                       ServerConfig(**scfg), device=device)
    for t in tenants:
        ref.register_tenant(t)
        with ref.session("s", tenant=t) as sess:
            _feed(sess, feeds[t])
    srv = IngestServer(str(tmp_path / "fleet.cameo"), cfg,
                       ServerConfig(max_sessions=4, **scfg), device=device)
    for t in tenants:
        srv.register_tenant(t)
    start = threading.Barrier(4)
    errs = []

    def producer(t):
        try:
            start.wait(timeout=60)
            with srv.session("s", tenant=t) as sess:
                _feed(sess, feeds[t])
        except Exception as e:        # noqa: BLE001 — reported below
            errs.append((t, repr(e)))

    threads = [threading.Thread(target=producer, args=(t,))
               for t in tenants]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert not errs
    for t in tenants:
        sid = tenant_sid(t, "s")
        assert _bodies(srv.store, sid) == _bodies(ref.store, sid), t
        assert _entry_key(srv.store, sid) == _entry_key(ref.store, sid), t
        srv.compact("s", tenant=t)
        ref.compact("s", tenant=t)
        assert _bodies(srv.store, sid) == _bodies(ref.store, sid), t
    srv.close()
    ref.close()


def test_concurrent_producers_match_serial(tmp_path):
    _concurrent_matches_serial(tmp_path, "cpu", N)


def test_quota_refused_before_journal(tmp_path):
    from repro_torch.server import QuotaExceeded
    pk = _package("torch")
    srv = _server(pk, str(tmp_path / "q.cameo"))
    srv.register_tenant("a", max_points=500)
    sess = srv.session("s", tenant="a")
    sess.push(_series(400, seed=1))
    n0, wal0 = sess.n_seen, os.path.getsize(srv.store._wal.path)
    with pytest.raises(QuotaExceeded):
        sess.push(_series(200, seed=2))
    assert sess.n_seen == n0
    assert os.path.getsize(srv.store._wal.path) == wal0   # never journaled
    sess.push(_series(100, seed=3))           # exactly to the cap
    sess.close()
    with pytest.raises(QuotaExceeded):
        srv.write("s2", _series(10, seed=4), tenant="a")
    with pytest.raises(QuotaExceeded):
        srv.view("a").write_batch({"u": _series(64, seed=1)})
    assert "s2" not in srv.view("a")
    assert srv.catalog.usage("a")["points"] == 500
    srv.close()


def test_admission_reject_and_duplicates(tmp_path):
    from repro_torch.server import ServerBusy
    pk = _package("torch")
    srv = _server(pk, str(tmp_path / "bp.cameo"), max_sessions=1,
                  backpressure="reject")
    s1 = srv.session("a")
    with pytest.raises(ServerBusy):
        srv.session("b")
    with pytest.raises(ServerBusy):
        srv.view().stream("c")
    s1.push(_series(256, seed=1))
    s1.close()
    with srv.session("b") as s2:
        s2.push(_series(256, seed=2))
    srv.close()
    srv = _server(pk, str(tmp_path / "dup.cameo"), max_sessions=4)
    s3 = srv.session("c")
    with pytest.raises(ValueError, match="already has an open session"):
        srv.session("c")
    s3.push(_series(128, seed=8))
    s3.close()
    for name in ("d", "e", "f", "g"):         # every slot still free
        with srv.session(name) as s:
            s.push(_series(128, seed=8))
    with pytest.raises(KeyError, match="unknown tenant"):
        srv.session("s", tenant="ghost")
    with pytest.raises(ValueError, match="must not contain"):
        srv.register_tenant("a/b")
    with pytest.raises(ValueError, match="backpressure"):
        _server(pk, str(tmp_path / "x.cameo"), backpressure="drop")
    srv.close()


def test_stats_and_metrics_count_pushes(tmp_path):
    import repro_torch.obs as obs
    from repro_torch.obs import OBS
    pk = _package("torch")
    was = obs.enabled()
    sinks = list(OBS._sinks)
    obs.reset()
    obs.enable()
    try:
        srv = _server(pk, str(tmp_path / "m.cameo"), auto_compact=True)
        srv.register_tenant("acme")
        with srv.session("s", tenant="acme") as sess:
            _feed(sess, _series(256, seed=7))
        srv.drain_compaction()
        st = srv.stats()
        assert st["sessions"] == 0 and st["series"] == 1
        assert st["tenants"]["acme"]["points"] == 256
        assert st["compaction"]["compacted"] == 1
        assert st["compaction"]["last_error"] is None
        txt = srv.metrics_text()
        assert 'cameo_server_tenant_points_total{tenant="acme"} 256' in txt
        assert f"cameo_server_pushes_total {-(-256 // CHUNK)}" in txt
        app = srv.metrics_app()
        seen = {}

        def start_response(status, headers):
            seen["status"] = status

        body = b"".join(app({"PATH_INFO": "/metrics"}, start_response))
        assert seen["status"].startswith("200")
        assert body.decode() == srv.metrics_text()
        b"".join(app({"PATH_INFO": "/x"}, start_response))
        assert seen["status"].startswith("404")
        srv.close()
    finally:
        OBS._sinks[:] = sinks
        obs.reset()
        OBS.enabled = was


# ---------------------------------------------------------------------------
# (e) the device
# ---------------------------------------------------------------------------

def test_server_defaults_to_the_card(tmp_path, monkeypatch):
    from repro_torch.core.cameo import CameoConfig
    from repro_torch.server import IngestServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IngestServer(str(tmp_path / "s.cameo"), CameoConfig(**CFG))
    assert not os.path.exists(tmp_path / "s.cameo")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_concurrent_producers_match_serial(cuda, tmp_path):
    _concurrent_matches_serial(tmp_path, "cuda", 2048)


_RACE = textwrap.dedent('''
    import sys, numpy as np, torch
    sys.path.insert(0, {tests!r})
    from test_torch_server import CFG, _series, _feed
    from repro_torch.core.cameo import CameoConfig
    from repro_torch.kernels import _build
    from repro_torch.server import IngestServer, ServerConfig
    assert _build._BUILDER._libs is None
    srv = IngestServer({path!r}, CameoConfig(**CFG),
                       ServerConfig(block_len=256, seal_block_len=64,
                                    stream_window=64, auto_compact=False),
                       resume=True, device="cuda")
    srv._compactor.enqueue("s")          # the worker thread compacts ...
    with srv.session("t") as sess:       # ... while this one builds
        _feed(sess, _series(2048, seed=2))
    srv.drain_compaction()
    assert srv._compactor.last_error is None, srv._compactor.last_error
    assert srv._compactor.compacted == 1
    np.save({out!r}, srv.series("s").window())
    srv.close()
''')


@pytest.mark.gpu
def test_gpu_compaction_races_first_build(cuda, tmp_path):
    """In a fresh process, the compaction thread reconstructs blocks on
    the card while the main thread's first push builds and launches the
    kernels: no error, and the compacted series decodes to the bits of
    the CPU's compaction of the same file."""
    from repro_torch.core.cameo import CameoConfig
    from repro_torch.server import IngestServer, ServerConfig
    scfg = ServerConfig(block_len=BLK, seal_block_len=SEAL, stream_window=W,
                        auto_compact=False)
    path = str(tmp_path / "r.cameo")
    srv = IngestServer(path, CameoConfig(**CFG), scfg, device="cpu")
    with srv.session("s") as sess:
        _feed(sess, _series(seed=11))
    srv.close()
    cpu = str(tmp_path / "cpu.cameo")
    shutil.copyfile(path, cpu)
    srv = IngestServer(cpu, CameoConfig(**CFG), scfg, resume=True,
                       device="cpu")
    assert srv.compact("s")["runs"] > 0
    want = srv.series("s").window()
    srv.close()
    out = str(tmp_path / "w.npy")
    code = _RACE.format(tests=os.path.dirname(os.path.abspath(__file__)),
                        path=path, out=out)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert np.load(out).tobytes() == want.tobytes()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        import jax
        jax.config.update("jax_enable_x64", True)
        _reference(sys.argv[2])
