"""The port's dataset façade (``repro_torch.api``) against the JAX
package's (``repro.api``): the same calls give the same file bytes, each
package reads, resumes and replays the other's files and journals, and
the pushdown answers agree.

The JAX side runs in a subprocess compiled without XLA's float rewrites
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``,
the compilation the port is held to, ROADMAP C1/C10), but for its PACF
answers, which run in a second subprocess under the default compilation
(the strict flags crash XLA on ``pacf_from_acf``, C1).  Held:
(a) file and journal bytes of ``write`` (univariate, a scalar ``eps``
    override), a multivariate ``write`` with per-column budgets, a finished
    ``stream`` and a stream stopped mid-feed (stashed in the footer);
    ``write_batch`` (one ``compress_batch`` group and a solo length)
    stores the bytes of solo ``write`` calls in both packages, but JAX's
    own batch lanes round the deviation otherwise (ROADMAP C11), so its
    ``write_batch`` file differs from the port's in the catalog's
    deviations alone;
(b) reads across packages: decoded windows, kept points and the pushdown
    ``sum/mean/var/acf`` answers with their bounds bit for bit; ``pacf``
    the port's ``pacf_from_acf`` of the ACF answer bit for bit, its bound
    (``torch.func.jacfwd``) within 1e-12 relative of JAX's ``jacfwd``
    bound, and both bounds covering the exact PACF of the decoded window;
(c) a stopped stream and a crash image (file and journal of a live
    writer) finished by either package give the uninterrupted stream's
    bytes, both ways round;
(d) the crash harness of ``tests/test_crash_safety.py``, scaled down,
    through the port's façade: the store truncated at every offset class
    past the journal checkpoint and the journal at record boundaries;
(e) the façade's validation, its default device (the card: without one it
    raises) and, on a card only, a ``write`` and a ``write_batch`` whose
    bytes equal ``CameoStore.append_series`` of the port's own results.
"""
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
CFG = dict(eps=2e-2, lags=12, mode="rounds", max_rounds=60, dtype="float64")
W = 1024          # stream window
CHUNK = 271
N_STREAM = 3000
STOP = 1332       # points fed before a stream is stopped or crashes
FLUSH = 813       # points fed before the crashed writer's flush
FILES = ("write", "batch_solo", "mv", "stream", "stream_mid")
KINDS = ("sum", "mean", "var", "acf")


def _series(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (np.sin(2 * np.pi * t / 24) + np.sin(2 * np.pi * t / 168)
            + 0.1 * rng.standard_normal(n))


def _mv():
    return np.stack([_series(1536, seed=14), _series(1536, seed=15) + 0.5],
                    axis=1)


def _batch():
    xs = {f"s{i}": _series(512, seed=10 + i) for i in range(3)}
    xs["long"] = _series(1024, seed=20)
    return xs


def _package(which):
    """The modules of one package, under one set of names."""
    if which == "jax":
        import repro.api as api
        from repro.core import cameo
        kw = {}
    else:
        import repro_torch.api as api
        from repro_torch.core import cameo
        kw = dict(device="cpu")
    return types.SimpleNamespace(name=which, api=api, kw=kw,
                                 cfg=cameo.CameoConfig(**CFG))


def _open(pk, path, mode, block_len=None):
    return pk.api.open(path, pk.cfg if mode != "r" else None, mode=mode,
                       block_len=block_len, stream_window=W, **pk.kw)


def _push_range(w, x, a, b):
    for i in range(a, b, CHUNK):
        w.push(x[i:min(i + CHUNK, b)])


def _snapshot_crash(store, p):
    """A live writer's OS-visible file and journal, copied to ``p`` (what
    a kill -9 leaves)."""
    store._f.flush()
    if store._wal is not None:
        store._wal._f.flush()
    shutil.copyfile(store.path, p)
    if store._wal is not None:
        shutil.copyfile(store._wal.path, p + ".wal")


def _write_all(pk, d):
    """Every write of one package into directory ``d``."""
    with _open(pk, os.path.join(d, "write.cameo"), "w", 512) as ds:
        ds.write("s", _series(2048, seed=1))
        ds.write("t", _series(1024, seed=2), eps=4e-2)
    with _open(pk, os.path.join(d, "batch.cameo"), "w", 256) as ds:
        ds.write_batch(_batch())
    with _open(pk, os.path.join(d, "batch_solo.cameo"), "w", 256) as ds:
        for sid, x in _batch().items():
            ds.write(sid, x)
    with _open(pk, os.path.join(d, "mv.cameo"), "w", 384) as ds:
        ds.write("m", _mv(), eps=[2e-2, 4e-2])
    x = _series(N_STREAM, seed=3)
    with _open(pk, os.path.join(d, "stream.cameo"), "w", 512) as ds:
        with ds.stream("s") as w:
            _push_range(w, x, 0, N_STREAM)
    ds = _open(pk, os.path.join(d, "stream_mid.cameo"), "w", 512)
    w = ds.stream("s")
    _push_range(w, x, 0, STOP)
    ds.close()                                 # stop mid-feed
    # the crash image: a flush, more pushes journaled, then a kill
    ds = _open(pk, os.path.join(d, "live.cameo"), "w", 512)
    w = ds.stream("s")
    _push_range(w, x, 0, FLUSH)
    ds.flush()
    _push_range(w, x, FLUSH, STOP)
    _snapshot_crash(ds.store, os.path.join(d, "crash.cameo"))
    w.close()
    ds.close()


def _finish(pk, path):
    """Resume the stopped or crashed stream at ``path`` and feed the
    rest; returns where it resumed."""
    ds = _open(pk, path, "a")
    w = ds.stream("s", resume=True)
    start = w.resume_from
    _push_range(w, _series(N_STREAM, seed=3), start, N_STREAM)
    w.close()
    ds.close()
    return start


def _read_all(pk, path, kinds=KINDS + ("pacf",)):
    """Everything a reader sees through the façade (the pushdown answers
    of ``kinds``)."""
    out = {}
    with _open(pk, path, "r") as ds:
        for sid in ds.sids():
            s = ds.series(sid)
            idx, vals = s.kept()
            out[f"{sid}/idx"], out[f"{sid}/vals"] = idx, vals
            out[f"{sid}/window"] = s.window()
            out[f"{sid}/slice"] = s.window(100, 900)
            for kind in kinds:
                for span, (a, b) in (("all", (None, None)),
                                     ("mid", (100, s.n - 100))):
                    v, bound = getattr(s, kind)(a, b)
                    out[f"{sid}/{kind}/{span}/value"] = np.asarray(v)
                    out[f"{sid}/{kind}/{span}/bound"] = np.asarray(bound)
    return out


def _jax_reads(out, name, kinds, only=""):
    """JAX's reads of the port's files (those whose key holds ``only``)."""
    pk = _package("jax")
    reads = {}
    for f in ("write", "batch", "mv", "stream"):
        path = os.path.join(out, "port", f"{f}.cameo")
        for k, v in _read_all(pk, path, kinds).items():
            if only in k:
                reads[f"{f}/{k}"] = v
    np.savez(os.path.join(out, name), **reads)


def _reference(out):
    """The JAX side, strict: its own files, its reads of the port's (but
    the PACF), and its finishing of the port's stopped and crashed streams
    (in copies)."""
    pk = _package("jax")
    jdir, pdir = os.path.join(out, "jax"), os.path.join(out, "port")
    _write_all(pk, jdir)
    _jax_reads(out, "jax_reads_port.npz", KINDS)
    for src, dst in ((pdir, "jax_finishes_port"), (jdir, "port_finishes_jax")):
        os.makedirs(os.path.join(out, dst))
        for name in ("stream_mid", "crash"):
            for suffix in ("", ".wal"):
                p = os.path.join(src, f"{name}.cameo{suffix}")
                if os.path.exists(p):
                    shutil.copyfile(p, os.path.join(out, dst,
                                                    f"{name}.cameo{suffix}"))
    starts = {}
    for name in ("stream_mid", "crash"):
        starts[name] = _finish(pk, os.path.join(out, "jax_finishes_port",
                                                f"{name}.cameo"))
    np.savez(os.path.join(out, "jax_starts.npz"), **starts)


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
    """The port's files (written first), then the JAX subprocess'; the
    stopped and crashed files are kept as they were, before any test
    finishes them."""
    out = str(tmp_path_factory.mktemp("api_xpkg"))
    for sub in ("port", "jax"):
        os.makedirs(os.path.join(out, sub))
    _write_all(_package("torch"), os.path.join(out, "port"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, out],
        env=dict(env, **extra), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for flag, extra in (("--reference", dict(XLA_FLAGS=STRICT_XLA_FLAGS)),
                            ("--reference-pacf", {}))]
    for proc in procs:
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log
    return out


@pytest.mark.parametrize("name", FILES)
def test_same_calls_same_bytes(files, name):
    for suffix in ("", ".wal"):
        p = os.path.join(files, "port", f"{name}.cameo{suffix}")
        j = os.path.join(files, "jax", f"{name}.cameo{suffix}")
        assert os.path.exists(p) == os.path.exists(j), suffix
        if os.path.exists(p):
            assert _bytes(p) == _bytes(j), name + suffix


def test_write_batch_stores_solo_writes(files):
    """The port's ``write_batch`` file is its own and JAX's solo writes of
    the same series, byte for byte.  JAX's ``write_batch`` file holds the
    same blocks and catalog but for the deviations, which its batch lanes
    round otherwise than its solo runs (ROADMAP C11): within 1e-14
    relative."""
    from repro_torch.store import CameoStore
    port = _bytes(os.path.join(files, "port", "batch.cameo"))
    assert port == _bytes(os.path.join(files, "port", "batch_solo.cameo"))
    assert port == _bytes(os.path.join(files, "jax", "batch_solo.cameo"))
    with CameoStore.open(os.path.join(files, "port", "batch.cameo"),
                         device="cpu") as a, \
            CameoStore.open(os.path.join(files, "jax", "batch.cameo"),
                            device="cpu") as b:
        assert a.series_ids() == b.series_ids() == list(_batch())
        for sid in a.series_ids():
            ea, eb = a.series_meta(sid), b.series_meta(sid)
            assert ea.keys() == eb.keys()
            for k in ea:
                if k == "deviation":
                    assert abs(ea[k] - eb[k]) <= 1e-14 * abs(eb[k]), sid
                elif k != "blocks":
                    assert ea[k] == eb[k], (sid, k)
            assert [bytes(x) for x in a._read_bodies(ea["blocks"])] == \
                [bytes(x) for x in b._read_bodies(eb["blocks"])], sid


def test_crash_images_same_bytes(files):
    """The live writers' crash images, file and journal, are the same
    bytes in both packages."""
    for suffix in ("", ".wal"):
        assert _bytes(os.path.join(files, "port", f"crash.cameo{suffix}")) \
            == _bytes(os.path.join(files, "jax", f"crash.cameo{suffix}"))


def _bits(a):
    a = np.atleast_1d(np.asarray(a))
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


@pytest.mark.parametrize("name", ["write", "batch", "mv", "stream"])
def test_reads_across_packages(files, name):
    """The port reads JAX's file bit for bit as its own; JAX reads the
    port's the same way, but for the PACF (each package's own
    Durbin-Levinson and Jacobian): values within 1e-12 (they lie in
    [-1, 1]), bounds within 1e-12 relative."""
    pk = _package("torch")
    mine = _read_all(pk, os.path.join(files, "port", f"{name}.cameo"))
    theirs = _read_all(pk, os.path.join(files, "jax", f"{name}.cameo"))
    jax_reads = {}
    for npz in ("jax_reads_port.npz", "jax_pacf_port.npz"):
        with np.load(os.path.join(files, npz)) as z:
            jax_reads.update({k[len(name) + 1:]: z[k] for k in z.files
                              if k.startswith(name + "/")})
    assert mine.keys() == theirs.keys() == jax_reads.keys()
    for k in mine:
        assert _bits(mine[k]) == _bits(theirs[k]), k
        if k.endswith("/pacf/all/bound") or k.endswith("/pacf/mid/bound"):
            np.testing.assert_allclose(jax_reads[k], mine[k], rtol=1e-12,
                                       atol=0, err_msg=k)
        elif "/pacf/" in k:
            np.testing.assert_allclose(jax_reads[k], mine[k], rtol=0,
                                       atol=1e-12, err_msg=k)
        else:
            assert _bits(mine[k]) == _bits(jax_reads[k]), k


@pytest.mark.parametrize("name", ["write", "mv"])
def test_pacf_value_and_bound(files, name):
    """The PACF value is the port's ``pacf_from_acf`` of the ACF answer
    bit for bit; its bound covers the exact PACF of the decoded window
    and is JAX's ``jacfwd`` bound within 1e-12 relative."""
    from repro_torch.core.acf import acf, pacf_from_acf
    pk = _package("torch")
    with np.load(os.path.join(files, "jax_pacf_port.npz")) as z:
        jax_reads = {k: z[k] for k in z.files}
    with _open(pk, os.path.join(files, "port", f"{name}.cameo"), "r") as ds:
        for sid in ds.sids():
            s = ds.series(sid)
            a, b = 100, s.n - 100
            r, _ = s.acf(a, b)
            pv, pb = s.pacf(a, b)
            cols = [None] if s.channels == 1 else range(s.channels)
            for c in cols:
                rc = r if c is None else r[c]
                pvc, pbc = (pv, pb) if c is None else (pv[c], pb[c])
                want = pacf_from_acf(torch.from_numpy(rc)).numpy()
                assert _bits(pvc) == _bits(want)
                xr = s.window(a, b, col=c)
                exact = pacf_from_acf(acf(torch.from_numpy(xr),
                                          CFG["lags"])).numpy()
                assert np.all(np.abs(pvc - exact) <= pbc)
            key = f"{name}/{sid}/pacf/mid/bound"
            np.testing.assert_allclose(pb, jax_reads[key], rtol=1e-12,
                                       atol=0)


@pytest.mark.parametrize("name", ["stream_mid", "crash"])
def test_finish_across_packages(files, name):
    """A stopped stream and a crash image finished by their own package or
    by the other one (either way round) give the uninterrupted stream's
    bytes; the crash image resumes at the last acked push."""
    want = _bytes(os.path.join(files, "jax", "stream.cameo"))
    pk = _package("torch")
    with np.load(os.path.join(files, "jax_starts.npz")) as z:
        assert int(z[name]) == STOP
    for sub in ("port", "port_finishes_jax"):
        path = os.path.join(files, sub, f"{name}.cameo")
        assert _finish(pk, path) == STOP
        assert _bytes(path) == want, sub
        assert not os.path.exists(path + ".wal")
    assert _bytes(os.path.join(files, "jax_finishes_port",
                               f"{name}.cameo")) == want


# ---------------------------------------------------------------------------
# (d) the crash harness, scaled down, through the port's façade
# ---------------------------------------------------------------------------

SMALL = dict(eps=2e-2, lags=8, mode="rounds", max_rounds=60, dtype="float64")
N_CRASH, W_CRASH, BLK_CRASH, CHUNK_CRASH = 640, 64, 64, 37


def _small_ds(p, mode):
    import repro_torch.api as api
    from repro_torch.core.cameo import CameoConfig
    return api.open(p, CameoConfig(**SMALL), mode=mode, block_len=BLK_CRASH,
                    stream_window=W_CRASH, device="cpu")


def _small_push(w, x, a, b):
    for i in range(a, b, CHUNK_CRASH):
        w.push(x[i:min(i + CHUNK_CRASH, b)])


def _small_clean(p, x, upto, flush_only=False):
    ds = _small_ds(p, "w")
    w = ds.stream("s")
    _small_push(w, x, 0, upto)
    if flush_only:
        ds.flush()
        blob = _bytes(p)
    w.close()
    ds.close()
    return blob if flush_only else _bytes(p)


def _small_crash(p, x, upto, flush_at=None):
    ds = _small_ds(p + ".live", "w")
    w = ds.stream("s")
    acked = 0
    for i in range(0, upto, CHUNK_CRASH):
        c = x[i:min(i + CHUNK_CRASH, upto)]
        w.push(c)
        acked += len(c)
        if flush_at is not None and acked >= flush_at:
            ds.flush()
            flush_at = None
    _snapshot_crash(ds.store, p)
    w.close()
    ds.close()
    return acked


def test_kill_at_every_store_offset(tmp_path):
    """The store cut at offset classes past the journal checkpoint
    (interior, the checkpoint's edge, the tail marker): recovery lands on
    the acked prefix, byte-identical to a clean run of those pushes."""
    from repro_torch.store import wal as walmod
    x = _series(N_CRASH, seed=7)
    img = tmp_path / "img"
    img.mkdir()
    p = str(img / "c.cameo")
    acked = _small_crash(p, x, 420, flush_at=200)
    store_blob, wal_blob = _bytes(p), _bytes(p + ".wal")
    floor = walmod.scan(p + ".wal").checkpoint.footer_offset
    assert floor <= len(store_blob)
    ref = _small_clean(str(tmp_path / "ref.cameo"), x, acked,
                       flush_only=True)
    tail = len(store_blob) - floor
    cuts = set(range(floor, len(store_blob) + 1, max(1, tail // 12)))
    cuts |= {floor, floor + 1, len(store_blob)}
    cuts |= {len(store_blob) - k for k in (1, 4, 8, 12)}
    for cut in sorted(cuts):
        work = tmp_path / f"w{cut}"
        work.mkdir()
        q = str(work / "c.cameo")
        with open(q, "wb") as f:
            f.write(store_blob[:cut])
        with open(q + ".wal", "wb") as f:
            f.write(wal_blob)
        ds = _small_ds(q, "a")
        w = ds.stream("s", resume=True)
        assert w.resume_from == acked, cut
        ds.flush()
        assert _bytes(q) == ref, cut
        w.close()
        ds.close()


def test_kill_at_every_wal_offset(tmp_path):
    """The journal cut at record boundaries and inside records: recovery
    lands on the last whole record, and feeding the rest from there gives
    the clean run's bytes."""
    from repro_torch.store import wal as walmod
    x = _series(N_CRASH, seed=7)
    img = tmp_path / "img"
    img.mkdir()
    p = str(img / "c.cameo")
    _small_crash(p, x, 300)                    # no flush: journal only
    store_blob, wal_blob = _bytes(p), _bytes(p + ".wal")
    ends = [pos for _, pos in walmod._iter_records(wal_blob)]
    assert len(ends) >= 3
    ref = _small_clean(str(tmp_path / "ref.cameo"), x, N_CRASH)
    cases, pts = [], 0
    for i, end in enumerate(ends[1:]):
        prev = pts
        pts += min(CHUNK_CRASH, 300 - i * CHUNK_CRASH)
        cases += [(end, pts), (end - 3, prev)]
    for k, (cut, want) in enumerate(cases):
        if want == 0:
            continue
        work = tmp_path / f"w{k}"
        work.mkdir()
        q = str(work / "c.cameo")
        with open(q, "wb") as f:
            f.write(store_blob)
        with open(q + ".wal", "wb") as f:
            f.write(wal_blob[:cut])
        ds = _small_ds(q, "a")
        w = ds.stream("s", resume=True)
        assert w.resume_from == want, cut
        if k % 3 == 0:
            _small_push(w, x, w.resume_from, N_CRASH)
            w.close()
            ds.close()
            assert _bytes(q) == ref, cut
        else:
            ds.close()


# ---------------------------------------------------------------------------
# (e) validation and the device
# ---------------------------------------------------------------------------

def test_open_modes_and_validation(tmp_path):
    import repro_torch.api as api
    from repro_torch.core.cameo import CameoConfig
    cfg = CameoConfig(**CFG)
    p = str(tmp_path / "m.cameo")
    with pytest.raises(ValueError, match="needs a CameoConfig"):
        api.open(p, device="cpu")
    with api.open(p, cfg, device="cpu") as ds:
        ds.write("s", _series(512, seed=7))
        assert ds.writable and "s" in ds and list(ds) == ["s"]
        with pytest.raises(ValueError, match=r"\[n\] or \[n, C\]"):
            ds.write("bad", np.zeros((4, 4, 4)))
        with pytest.raises(ValueError, match="1-D"):
            ds.write_batch({"m": np.zeros((64, 2))})
    ds = api.open(p, device="cpu")
    assert not ds.writable
    with pytest.raises(IOError, match="read-only"):
        ds.write("t", _series(512))
    assert ds.stats()["series"] == 1
    ds.close()
    with pytest.raises(ValueError, match="unknown mode"):
        api.open(p, cfg, mode="x", device="cpu")
    with pytest.raises(ValueError, match="different store-layout"):
        api.open(p, cfg, mode="a", block_len=128, device="cpu")
    with api.open(p, cfg, mode="a", device="cpu") as ds:
        view = ds.view("t/")
        view.write("u", _series(512, seed=8))
        assert view.sids() == ["u"] and "u" in view
    with api.open(p, device="cpu") as ds:
        assert sorted(ds.sids()) == ["s", "t/u"]


def test_open_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``device=`` the façade runs on the card; without a card it
    raises rather than fall back to the CPU."""
    import repro_torch.api as api
    from repro_torch.core.cameo import CameoConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.open(str(tmp_path / "c.cameo"), CameoConfig(**CFG))
    assert not os.path.exists(tmp_path / "c.cameo")


def test_facade_imports_no_jax():
    """The façade, the server, the service shim and chip_smoke.py's facade
    phase import neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import repro_torch.api, repro_torch.api.dataset\n"
        "import repro_torch.server, repro_torch.serving.ts_service\n"
        "from repro_torch.server import (catalog, compaction, "
        "ingest_server, tiers)\n"
        "from chip_smoke import run_facade\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_facade_rehearsal():
    """chip_smoke.py's facade phase at a tiny size on the CPU, where every
    wrapper takes its plain version (the script itself refuses to run
    without a card): every step and hold runs, no kernel is counted."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    out = chip_smoke.run_facade(
        "cpu", sizes=dict(uk_n=1024, aus_n=48 * 40, batch_B=3,
                          batch_held=(0, 2), mv_C=2, seq_n=256,
                          server_n=1024, service_B=2, query=(100, 900)),
        log=lambda line: None)
    assert list(out["steps"]) == [
        "write uk_elec", "write aus_elec", "write_batch uk_elec",
        "write multivariate", "write scan uk_elec",
        "write sequential uk_elec", "server 4 threads", "service 2 submits"]
    st = out["steps"]
    assert st["write uk_elec"]["bytes_equal_append"]
    assert 0 <= st["write uk_elec"]["query_err_over_bound"] <= 1
    assert st["write_batch uk_elec"]["compress_batch_calls"] == 1
    assert st["write_batch uk_elec"]["lanes_equal_solo"] == 2
    srv = st["server 4 threads"]
    assert srv["series_equal_serial"] == 4 and srv["compacted"] == 4
    assert srv["counters"]["server.points"] == 4 * 1024
    assert srv["counters"]["server.quota_rejects"] == 1
    assert all(v["file_bytes"] > 0 and v["points_per_s"] > 0
               for v in st.values())
    assert set(out["launches"].values()) == {0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_write_equals_store_append(cuda, tmp_path):
    """On the card: ``write`` and each lane of ``write_batch`` store the
    bytes ``CameoStore.append_series`` stores for the port's own
    ``compress`` of the series on the card."""
    import repro_torch.api as api
    from repro_torch.core.cameo import CameoConfig, compress
    from repro_torch.store import CameoStore
    cfg = CameoConfig(**CFG)
    xs = {f"s{i}": _series(2048, seed=30 + i) for i in range(3)}
    pa, pb = str(tmp_path / "a.cameo"), str(tmp_path / "b.cameo")
    with api.open(pa, cfg, block_len=512, wal=False) as ds:
        ds.write("one", xs["s0"])
        ds.write_batch(xs)
    with CameoStore.create(pb, block_len=512, wal=False) as st:
        st.append_series("one", compress(xs["s0"], cfg), cfg, x=xs["s0"])
        for sid, x in xs.items():
            st.append_series(sid, compress(x, cfg), cfg, x=x)
    assert _bytes(pa) == _bytes(pb)
    with api.open(pa, device=cuda) as ds:
        s = ds.series("one")
        v, bound = s.pacf(100, 1900)
        assert np.all(np.isfinite(v)) and np.all(bound > 0)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)
    if sys.argv[1] == "--reference":
        _reference(sys.argv[2])
    elif sys.argv[1] == "--reference-pacf":
        _jax_reads(sys.argv[2], "jax_pacf_port.npz", ("pacf",), "/pacf/")
