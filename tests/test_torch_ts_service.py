"""The port's deprecated service shim (``repro_torch.serving.ts_service``)
against the JAX package's, and against the port's own façade.

The JAX side runs in a subprocess compiled without XLA's float rewrites
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``,
the compilation the port is held to, ROADMAP C1/C10).  Held:
(a) ``submit`` of a fleet whose series have one length each (solo
    compressions in both packages, ROADMAP C11), a ``flush``, an
    ``ingest_stream`` and a service closed mid-stream: the same file and
    journal bytes as JAX's service;
(b) either package resumes the other's service closed mid-stream
    (``resume=True``, ``ingest_stream(sid, resume=True)``) to the bytes of
    the uninterrupted feed;
(c) ``submit`` groups of one length run as one ``compress_batch`` whose
    file equals ``Dataset.write_batch`` of the same series, and both the
    solo writes' bytes; queries serve flushed series; ``stats()`` has the
    reference's keys and values;
(d) the deprecation warnings, with the reference's messages;
(e) the default device (the card: without one it raises) and, on a card
    only, 8 submits and a flush byte-equal to ``Dataset.write_batch``.
"""
import os
import shutil
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
CFG = dict(eps=2e-2, lags=12, mode="rounds", max_rounds=60, dtype="float64")
WLEN = 256
N_FEED = 700
STOP = 390


def _fleet(lengths, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for i, n in enumerate(lengths):
        t = np.arange(n)
        out[f"s{i}"] = (np.sin(2 * np.pi * t / 24 + i)
                        + 0.1 * rng.standard_normal(n))
    return out


def _feed():
    return _fleet([N_FEED], seed=5)["s0"]


def _package(which):
    if which == "jax":
        from repro.core import cameo
        from repro.serving import ts_service
        kw = {}
    else:
        from repro_torch.core import cameo
        from repro_torch.serving import ts_service
        kw = dict(device="cpu")
    return types.SimpleNamespace(name=which, svc=ts_service, kw=kw,
                                 cfg=cameo.CameoConfig(**CFG))


def _service(pk, path, resume=False, **kw):
    scfg = pk.svc.TsServiceConfig(block_len=128, stream_window=WLEN, **kw)
    return pk.svc.TimeSeriesService(path, pk.cfg, scfg, resume=resume,
                                    **pk.kw)


def _push(h, x, a, b):
    for lo in range(a, b, 130):
        h.push(x[lo:min(lo + 130, b)])


def _serve_all(pk, d):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with _service(pk, os.path.join(d, "fleet.cameo"), max_batch=2) as s:
            for sid, x in _fleet([512, 640, 768], seed=1).items():
                s.submit(sid, x)
            s.flush()
            h = s.ingest_stream("feed")
            _push(h, _feed(), 0, N_FEED)
            h.close()
        with _service(pk, os.path.join(d, "feed.cameo")) as s:
            h = s.ingest_stream("feed")
            _push(h, _feed(), 0, N_FEED)
            h.close()
        s = _service(pk, os.path.join(d, "stopped.cameo"))
        h = s.ingest_stream("feed")
        _push(h, _feed(), 0, STOP)
        s.close()                             # closed mid-stream


def _finish(pk, path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with _service(pk, path, resume=True) as s:
            h = s.ingest_stream("feed", resume=True)
            start = h.resume_from
            _push(h, _feed(), start, N_FEED)
            h.close()
    return start


def _reference(out):
    pk = _package("jax")
    jdir = os.path.join(out, "jax")
    _serve_all(pk, jdir)
    for src, dst in ((os.path.join(out, "port"), "jax_finishes_port"),
                     (jdir, "port_finishes_jax")):
        os.makedirs(os.path.join(out, dst))
        for suffix in ("", ".wal"):
            p = os.path.join(src, f"stopped.cameo{suffix}")
            if os.path.exists(p):
                shutil.copyfile(p, os.path.join(out, dst,
                                                f"stopped.cameo{suffix}"))
    start = _finish(pk, os.path.join(out, "jax_finishes_port",
                                     "stopped.cameo"))
    _finish(pk, os.path.join(jdir, "stopped.cameo"))
    with _service(pk, os.path.join(jdir, "fleet.cameo"), resume=True) as s:
        stats = s.stats()
    np.savez(os.path.join(out, "jax.npz"), start=np.asarray(start),
             stats_keys=np.asarray(sorted(stats)),
             stats_vals=np.asarray([float(stats[k]) for k in sorted(stats)
                                    if k != "cache"]))


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
    out = str(tmp_path_factory.mktemp("svc_xpkg"))
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


@pytest.mark.parametrize("name", ["fleet", "feed", "stopped"])
def test_same_calls_same_bytes(files, name):
    for suffix in ("", ".wal"):
        p = os.path.join(files, "port", f"{name}.cameo{suffix}")
        j = os.path.join(files, "jax", f"{name}.cameo{suffix}")
        if name == "stopped":     # JAX's own was finished in place
            j = os.path.join(files, "port_finishes_jax",
                             f"{name}.cameo{suffix}")
        assert os.path.exists(p) == os.path.exists(j), suffix
        if os.path.exists(p):
            assert _bytes(p) == _bytes(j), name + suffix


def test_resume_across_packages(files):
    """A service closed mid-stream, resumed by its own package or by the
    other one, finishes to the bytes of the uninterrupted feed."""
    pk = _package("torch")
    want = _bytes(os.path.join(files, "jax", "feed.cameo"))
    assert _bytes(os.path.join(files, "jax", "stopped.cameo")) == want
    with np.load(os.path.join(files, "jax.npz")) as z:
        assert int(z["start"]) > 0
        start = int(z["start"])
    assert _bytes(os.path.join(files, "jax_finishes_port",
                               "stopped.cameo")) == want
    for sub in ("port", "port_finishes_jax"):
        path = os.path.join(files, sub, "stopped.cameo")
        assert _finish(pk, path) == start
        assert _bytes(path) == want, sub


def test_stats_equal_reference(files):
    pk = _package("torch")
    with _service(pk, os.path.join(files, "port", "fleet.cameo"),
                  resume=True) as s:
        stats = s.stats()
    with np.load(os.path.join(files, "jax.npz")) as z:
        assert sorted(stats) == list(z["stats_keys"])
        assert [float(stats[k]) for k in sorted(stats) if k != "cache"] \
            == list(z["stats_vals"])


def test_submit_groups_equal_write_batch(tmp_path):
    """A group of one length is one ``compress_batch``: the service's file
    equals ``Dataset.write_batch`` of the fleet and the solo writes';
    flushed series serve queries before the rest are ingested."""
    import repro_torch.api as api
    from repro_torch.core.cameo import CameoConfig, compress
    cfg = CameoConfig(**CFG)
    pk = _package("torch")
    fleet = _fleet([512] * 5 + [1024] * 2)
    p = str(tmp_path / "svc.cameo")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with _service(pk, p, max_batch=4) as svc:
            for sid, x in fleet.items():
                svc.submit(sid, x)
            st = svc.stats()
            assert st["ingested"] == 4 and st["pending"] == 3
            ref = compress(fleet["s0"], cfg, device="cpu").xr.numpy()
            assert np.array_equal(svc.query_window("s0", 40, 200),
                                  ref[40:200])
            v, b = svc.query_aggregate("s1", "mean", 10, 400)
            assert abs(v - fleet["s1"][10:400].mean()) <= b
            with pytest.raises(ValueError, match="already submitted"):
                svc.submit("s0", fleet["s0"])
    first4 = dict(list(fleet.items())[:4])
    rest = dict(list(fleet.items())[4:])
    for name, write in (("batch", lambda ds, xs: ds.write_batch(xs)),
                        ("solo", lambda ds, xs: [ds.write(s, x)
                                                 for s, x in xs.items()])):
        q = str(tmp_path / f"{name}.cameo")
        with api.open(q, cfg, block_len=128, stream_window=WLEN,
                      device="cpu") as ds:
            write(ds, first4)
            write(ds, {k: rest[k] for k in ("s4",)})
            write(ds, {k: rest[k] for k in ("s5", "s6")})
        assert _bytes(q) == _bytes(p), name


def test_deprecation_warnings(tmp_path):
    pk = _package("torch")
    x = _fleet([512], seed=12)["s0"]
    with _service(pk, str(tmp_path / "w.cameo")) as svc:
        with pytest.warns(DeprecationWarning, match="submit is deprecated"):
            svc.submit("s", x)
        svc.flush()
        with pytest.warns(DeprecationWarning,
                          match="ingest_stream is deprecated"):
            h = svc.ingest_stream("t")
        h.push(x)
        h.close()
        assert svc.stats()["streams"] == 0 and svc.stats()["ingested"] == 2


def test_service_defaults_to_the_card(tmp_path, monkeypatch):
    from repro_torch.core.cameo import CameoConfig
    from repro_torch.serving.ts_service import TimeSeriesService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TimeSeriesService(str(tmp_path / "s.cameo"), CameoConfig(**CFG))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_submits_equal_write_batch(cuda, tmp_path):
    import repro_torch.api as api
    from repro_torch.core.cameo import CameoConfig
    from repro_torch.serving.ts_service import (TimeSeriesService,
                                                TsServiceConfig)
    cfg = CameoConfig(**CFG)
    fleet = _fleet([2048] * 8, seed=21)
    p, q = str(tmp_path / "svc.cameo"), str(tmp_path / "ds.cameo")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with TimeSeriesService(p, cfg, TsServiceConfig(block_len=512)) as s:
            for sid, x in fleet.items():
                s.submit(sid, x)
            s.flush()
    with api.open(q, cfg, block_len=512) as ds:
        ds.write_batch(fleet)
    assert _bytes(p) == _bytes(q)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        import jax
        jax.config.update("jax_enable_x64", True)
        _reference(sys.argv[2])
