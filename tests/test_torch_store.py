"""The port's block store (``repro_torch.store``) against the JAX package's
(``repro.store``): the same writes give the same file bytes, and each
package reads the other's files.

The JAX side runs in a subprocess compiled without XLA's float rewrites
(the compilation the port is held to, ROADMAP C1/C10): the store's bytes
hold a block's reconstruction moments, and the default compilation's
fused multiply-add in the interpolation changes their last bits.

Held byte for byte (each package writes its own compressor's results),
for each write and its write-ahead journal:
(a) a plain series (``append_series`` of ``compress`` with the original
    series for residual metadata);
(b) a stream session (``open_stream`` fed by each package's own
    ``StreamingCompressor``): the file at a mid-stream ``flush``, the
    session stashed in the footer with the compressor's state (the store
    closed mid-stream), and the final file after a ``mode="a"`` resume;
(c) a multivariate series and a multivariate stream session, likewise;
(d) the other package's files read bit for bit (kept points, decoded
    series) and its mid-stream file resumed with ``mode="a"`` to the same
    final bytes, both ways;
(e) pushdown ``query`` answers (sum, mean, var, ACF with their bounds)
    equal on the same bytes in both packages.
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
CFG = dict(eps=2e-2, lags=8, mode="rounds", max_rounds=60, dtype="float64")
W = 256
BLOCK = 200
QUERIES = [("sum", None, None), ("mean", 100, 900), ("var", 333, 1201),
           ("acf", None, None), ("acf", 250, 1000)]


def _series(n, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (3 * np.sin(2 * np.pi * t / 24) + np.sin(2 * np.pi * t / 168)
            + 0.2 * rng.standard_normal(n) + offset)


def _plain():
    return _series(1280, seed=3, offset=5.0)


def _mv():
    return np.stack([_series(1280, seed=30 + c, offset=2.0 * c)
                     for c in range(2)], 1)


def _cuts(n, seed):
    rng = np.random.default_rng(seed)
    return sorted(int(c) for c in rng.integers(0, n, 5))


def _package(which):
    """The modules of one package, under one set of names."""
    if which == "jax":
        import jax.numpy as jnp
        from repro.core import cameo, streaming
        from repro.store import query, store
        arr = jnp.asarray
        kw = {}
    else:
        from repro_torch.core import cameo, streaming
        from repro_torch.store import query, store
        arr = np.asarray
        kw = dict(device="cpu")
    return types.SimpleNamespace(
        name=which, cameo=cameo, streaming=streaming, query=query,
        Store=store.CameoStore, cfg=cameo.CameoConfig(**CFG), arr=arr, kw=kw)


def _streamer(pk, channels=None, **state):
    S = pk.streaming
    if state:
        return S.compressor_from_state(pk.cfg, state["state"], **pk.kw)
    if channels is None:
        return S.StreamingCompressor(pk.cfg, W, queue_depth=2, **pk.kw)
    return S.MVStreamingCompressor(pk.cfg, W, channels, **pk.kw)


def _create(pk, path):
    return pk.Store.create(path, block_len=BLOCK, version=4, **pk.kw)


def _open(pk, path, mode="r"):
    return pk.Store.open(path, mode, **pk.kw)


def _write_plain(pk, path):
    x = _plain()
    res = pk.cameo.compress(pk.arr(x), pk.cfg, **pk.kw)
    with _create(pk, path) as s:
        s.append_series("plain", res, pk.cfg, x=x)


def _write_mv(pk, path):
    X = _mv()
    res = pk.cameo.compress_multivariate(X, pk.cfg, **pk.kw)
    with _create(pk, path) as s:
        s.append_series("mv", res, pk.cfg, x=X)


def _stream_into(pk, path, x, channels=None, *, stop_after=None,
                 flush_at=None, snap=None):
    """Stream ``x`` (chunked) through the package's compressor into a new
    store session.  ``flush_at``: after that chunk, flush and copy the
    file and its journal to ``snap``.  ``stop_after``: close the store
    after that chunk, leaving the session stashed, with the compressor's
    state, for a resume."""
    sid = "stream" if channels is None else "mvstream"
    sc = _streamer(pk, channels)
    store = _create(pk, path)
    sess = store.open_stream(sid, pk.cfg, channels=channels or 1)
    if stop_after is not None:
        sess.state_provider = sc.state_dict
    for ci, chunk in enumerate(np.split(x, _cuts(x.shape[0], 9))):
        sess.append_windows(sc.push(chunk))
        if ci == flush_at:
            sess.flush()
            for suffix in ("", ".wal"):
                if os.path.exists(path + suffix):
                    shutil.copyfile(path + suffix, snap + suffix)
        if ci == stop_after:
            store.close()
            return
    _finish_stream(pk, sc, sess, store, channels)


def _finish_stream(pk, sc, sess, store, channels):
    sess.append_windows(sc.finish())
    if channels is None:
        sess.close()
    else:
        sess.close(deviations=[0.0] * channels)
    store.close()


def _resume_stream(pk, path, x, channels=None, *, stop_after):
    """Reopen a stashed session (``mode="a"``) and feed the rest."""
    sid = "stream" if channels is None else "mvstream"
    store = _open(pk, path, "a")
    sess = store.open_stream(sid, pk.cfg, resume=True)
    sc = _streamer(pk, state=sess.restored_client_state)
    sess.state_provider = sc.state_dict
    for chunk in np.split(x, _cuts(x.shape[0], 9))[stop_after + 1:]:
        sess.append_windows(sc.push(chunk))
    _finish_stream(pk, sc, sess, store, channels)


def _read_all(pk, path):
    """Everything a reader sees: per series its kept points, decoded
    series and pushdown answers."""
    out = {}
    with _open(pk, path) as s:
        for sid in s.series_ids():
            idx, vals = s.read_kept(sid)
            out[f"{sid}/idx"] = idx
            out[f"{sid}/vals"] = vals
            out[f"{sid}/series"] = s.read_series(sid)
            for i, (kind, a, b) in enumerate(QUERIES):
                v, bound = pk.query.query(s, sid, kind, a, b)
                out[f"{sid}/q{i}/value"] = np.asarray(v)
                out[f"{sid}/q{i}/bound"] = np.asarray(bound)
    return out


def _write_all(pk, d):
    """Every write of one package into directory ``d``."""
    _write_plain(pk, os.path.join(d, "plain.cameo"))
    _write_mv(pk, os.path.join(d, "mv.cameo"))
    x, X = _plain(), _mv()
    _stream_into(pk, os.path.join(d, "stream.cameo"), x)
    _stream_into(pk, os.path.join(d, "stream_flushed.cameo"), x, flush_at=2,
                 snap=os.path.join(d, "stream_flush.cameo"))
    _stream_into(pk, os.path.join(d, "stream_mid.cameo"), x, stop_after=3)
    _stream_into(pk, os.path.join(d, "mvstream.cameo"), X, channels=2)
    _stream_into(pk, os.path.join(d, "mvstream_mid.cameo"), X, channels=2,
                 stop_after=2)


def _resume_all(pk, d):
    """Finish the stashed sessions in ``d`` (written by either package)."""
    _resume_stream(pk, os.path.join(d, "stream_mid.cameo"), _plain(),
                   stop_after=3)
    _resume_stream(pk, os.path.join(d, "mvstream_mid.cameo"), _mv(),
                   channels=2, stop_after=2)


FILES = ("plain", "mv", "stream", "stream_mid", "mvstream", "mvstream_mid")


def _reference(out):
    """The JAX side, in a strict-compiled subprocess: its own files, its
    reads of the port's files, and its resume of the port's stashed
    sessions."""
    pk = _package("jax")
    jdir, pdir = os.path.join(out, "jax"), os.path.join(out, "port")
    _write_all(pk, jdir)
    reads = {}
    for name in ("plain", "mv", "stream", "mvstream"):
        for k, v in _read_all(pk, os.path.join(pdir, f"{name}.cameo")).items():
            reads[f"{name}/{k}"] = v
    np.savez(os.path.join(out, "jax_reads_port.npz"), **reads)
    # the port's stashed sessions, finished by JAX (in a copy)
    rdir = os.path.join(out, "jax_resumed_port")
    os.makedirs(rdir)
    for name in ("stream_mid", "mvstream_mid"):
        for suffix in ("", ".wal"):
            src = os.path.join(pdir, f"{name}.cameo{suffix}")
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(rdir,
                                                  f"{name}.cameo{suffix}"))
    _resume_all(pk, rdir)
    # JAX's stashed sessions, copied for the port to finish, then its own
    mid = os.path.join(out, "port_resumed_jax")
    os.makedirs(mid)
    for name in ("stream_mid", "mvstream_mid"):
        for suffix in ("", ".wal"):
            src = os.path.join(jdir, f"{name}.cameo{suffix}")
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(mid,
                                                  f"{name}.cameo{suffix}"))
    _resume_all(pk, jdir)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory, one_torch_thread):
    """The port's files (written first), then the JAX subprocess'."""
    out = str(tmp_path_factory.mktemp("store_xpkg"))
    pdir = os.path.join(out, "port")
    os.makedirs(pdir)
    os.makedirs(os.path.join(out, "jax"))
    pk = _package("torch")
    _write_all(pk, pdir)
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", out],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the stashed sessions (files and journals), before any test resumes
    # them (JAX finished its own; its stashed files were copied first)
    mid = {}
    for pkg, sub in (("port", "port"), ("jax", "port_resumed_jax")):
        for name in ("stream_mid", "mvstream_mid"):
            for suffix in ("", ".wal"):
                path = os.path.join(out, sub, f"{name}.cameo{suffix}")
                if os.path.exists(path):
                    mid[f"{pkg}/{name}{suffix}"] = _bytes(path)
    return dict(dir=out, mid=mid)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["plain", "mv", "stream", "mvstream",
                                  "stream_flush", "stream_flushed"])
def test_same_writes_same_bytes(files, name):
    for suffix in ("", ".wal"):
        p = os.path.join(files["dir"], "port", f"{name}.cameo{suffix}")
        j = os.path.join(files["dir"], "jax", f"{name}.cameo{suffix}")
        assert os.path.exists(p) == os.path.exists(j), suffix
        if os.path.exists(p):
            assert _bytes(p) == _bytes(j), name + suffix


@pytest.mark.parametrize("name", ["stream_mid", "mvstream_mid"])
def test_stashed_sessions_same_bytes(files, name):
    """A store closed mid-stream stashes the session and the compressor's
    state (running aggregates included) in its footer: the same bytes in
    both packages, journal included."""
    mid = files["mid"]
    assert f"port/{name}" in mid
    for suffix in ("", ".wal"):
        assert mid.get(f"port/{name}{suffix}") == mid.get(
            f"jax/{name}{suffix}"), suffix


@pytest.mark.parametrize("name", ["stream_mid", "mvstream_mid"])
def test_mode_a_resume_across_packages(files, name):
    """A stashed session finished by its own package, or by the other one
    (either way round), gives the uninterrupted stream's bytes."""
    want = _bytes(os.path.join(files["dir"], "jax",
                               name.replace("_mid", "") + ".cameo"))
    assert _bytes(os.path.join(files["dir"], "jax", f"{name}.cameo")) == want
    pk = _package("torch")
    port_own = os.path.join(files["dir"], "port", f"{name}.cameo")
    _resume_all_one(pk, port_own, name)
    assert _bytes(port_own) == want
    assert _bytes(os.path.join(files["dir"], "jax_resumed_port",
                               f"{name}.cameo")) == want
    theirs = os.path.join(files["dir"], "port_resumed_jax", f"{name}.cameo")
    _resume_all_one(pk, theirs, name)
    assert _bytes(theirs) == want


def _resume_all_one(pk, path, name):
    if name == "stream_mid":
        _resume_stream(pk, path, _plain(), stop_after=3)
    else:
        _resume_stream(pk, path, _mv(), channels=2, stop_after=2)


@pytest.mark.parametrize("name", ["plain", "mv", "stream", "mvstream"])
def test_reads_across_packages(files, name):
    """The port reads JAX's file as JAX reads the port's (kept points,
    decoded series and pushdown answers, bit for bit), and both equal what
    the port reads from its own file."""
    pk = _package("torch")
    mine = _read_all(pk, os.path.join(files["dir"], "port", f"{name}.cameo"))
    theirs = _read_all(pk, os.path.join(files["dir"], "jax", f"{name}.cameo"))
    with np.load(os.path.join(files["dir"], "jax_reads_port.npz")) as z:
        jax_reads = {k[len(name) + 1:]: z[k] for k in z.files
                     if k.startswith(name + "/")}
    assert mine.keys() == theirs.keys() == jax_reads.keys()
    for k in mine:
        for other in (theirs[k], jax_reads[k]):
            assert mine[k].dtype == other.dtype, k
            assert np.array_equal(np.atleast_1d(mine[k]).view(np.uint8),
                                  np.atleast_1d(other).view(np.uint8)), k


def test_store_reconstruction_matches_compress_xr(files):
    """The decoded series is the compressor's ``xr`` bit for bit (the
    port's ``_reconstruct`` over each block's span, no padding)."""
    from repro_torch.core.cameo import CameoConfig, compress
    x = _plain()
    res = compress(x, CameoConfig(**CFG), device="cpu")
    pk = _package("torch")
    with _open(pk, os.path.join(files["dir"], "port", "plain.cameo")) as s:
        got = s.read_series("plain")
        assert np.array_equal(s.kept_mask("plain"), res.kept.numpy())
    assert np.array_equal(got.view(np.uint8), res.xr.numpy().view(np.uint8))


def test_store_takes_card_tensors_at_its_edge(tmp_path, monkeypatch):
    """Result fields that are torch tensors become numpy at the store's
    edge; a store made for the card refuses to run without one."""
    from repro_torch.core.cameo import CameoConfig, compress
    from repro_torch.store import CameoStore
    from repro_torch.store.codec import compression_ratio_bytes
    x = _series(600, seed=1)
    cfg = CameoConfig(**CFG)
    res = compress(x, cfg, device="cpu")
    assert compression_ratio_bytes(res) > 1.0
    path = str(tmp_path / "t.cameo")
    with CameoStore.create(path, device="cpu") as s:
        s.append_series("a", res, cfg, x=torch.from_numpy(x))
    with CameoStore.open(path, device="cpu") as s:
        assert s.series_meta("a")["n_kept"] == int(res.n_kept)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with CameoStore.open(path) as s:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.read_series("a")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        import jax
        jax.config.update("jax_enable_x64", True)
        _reference(sys.argv[2])
