"""The port's streaming ingest (``repro_torch.core.streaming``) against the
JAX package's (``repro.core.streaming``), on the CPU.

Port and JAX are fed the same chunks of the same series (``CFG`` and the
series of ``tests/test_streaming.py``: eps 2e-2, L 8, windows of 256).
Held, in each case: the windows (start, kept mask, ``xr``, iterations)
and ``deviation()`` bit for bit (the port's sums take the reference's
order: the running aggregates' lagged products through ``lag_dot``'s
plain version, left to right, as the reference's, ROADMAP C2).

The JAX side runs in a subprocess compiled without XLA's float rewrites
(ROADMAP C1): its default compilation contracts the interpolation
``xp + (xq - xp) * t`` into a fused multiply-add and turns ``/ kappa``
into ``* (1 / kappa)``, so its reconstructions part from the port's (and
from its own strict compilation) in the last bit of dead points, and a
kappa > 1 stream can take another path at a near-tie (ROADMAP C10); the
kept masks of the kappa = 1 cases equal the default compilation's too
(``test_default_compilation_kept_masks``).

Cases: one chunk and seeded chunkings at kappa 1, queue depths 1 and 3,
a kappa = 4 stream whose tail is compressed with a verbatim kappa
remainder and one whose tail is kept whole, and the multivariate
compressor.  The sequential mode is held to the default compilation in
process (the strict flags crash XLA on it, ROADMAP C1): kept masks and
iterations equal, ``xr`` and the deviation within 1e-12.  A
``state_dict`` written mid-stream by one package resumes in the other,
both ways (univariate with queued windows, and multivariate), and ends
bit-equal to the uninterrupted run.  The port alone: chunking invariance
(hypothesis), queue-depth invariance, the state's keys and types, the
deprecated shims, and, on a card, a stream at queue depths 1 and 4.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from conftest import hypothesis_or_stubs
from repro.core import streaming as js
from repro.core.cameo import CameoConfig as JConfig
from repro_torch.core import streaming as ts
from repro_torch.core.cameo import CameoConfig as TConfig
from repro_torch.obs import OBS

given, settings, st = hypothesis_or_stubs()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
CFG = dict(eps=2e-2, lags=8, mode="rounds", max_rounds=60, dtype="float64")
W = 256


def _series(n, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (3 * np.sin(2 * np.pi * t / 24) + np.sin(2 * np.pi * t / 168)
            + 0.2 * rng.standard_normal(n) + offset)


def _cuts(n, seed, k=5):
    return sorted(int(c) for c in
                  np.random.default_rng(seed).integers(0, n, k))


# name -> (cfg overrides, series, chunk cuts, queue depth, window); one
# chunk where cuts is None
CASES = {
    "k1_one_chunk": ({}, (900, 3), None, 1, W),
    "k1_chunked": ({}, (900, 3), 11, 1, W),
    "k1_queue3": ({}, (1100, 5), 12, 3, W),
    "k4_tail_remainder": (dict(kappa=4), (811, 7), 13, 2, W),
    "k4_tail_verbatim": (dict(kappa=4), (542, 8), 14, 1, W),
}
# the sequential mode is held to JAX's default compilation, in process
# (the strict flags crash XLA on it), as tests/test_torch_sequential.py does
SEQ_CASE = (dict(mode="sequential", hops=8, window=16), (300, 9), 15, 2, 128)
MV_CASE = ((700, 2), 16, W)
# resume across packages: (case, number of chunks fed before the pause)
RESUME = {"uni": ("k1_queue3", 3), "mv": (None, 2)}


def _case_input(name):
    over, (n, seed), cut_seed, qd, wlen = (SEQ_CASE if name == "sequential"
                                           else CASES[name])
    x = _series(n, seed)
    cuts = None if cut_seed is None else _cuts(n, cut_seed)
    return dict(CFG, **over), x, cuts, qd, wlen


def _mv_input():
    (n, C), cut_seed, wlen = MV_CASE
    X = np.stack([_series(n, seed=20 + c, offset=c) for c in range(C)], 1)
    return X, _cuts(n, cut_seed), wlen


def _chunks(x, cuts):
    return [x] if cuts is None else np.split(x, cuts)


def _stream(sc, chunks):
    wins = []
    for c in chunks:
        wins += sc.push(c)
    return wins + sc.finish()


def _windows(wins):
    """Every window field as plain data (numpy arrays kept)."""
    return dict(start=np.array([w.start for w in wins]),
                iters=np.array([w.iters for w in wins]),
                n_kept=np.array([w.n_kept for w in wins]),
                kept=np.concatenate([w.kept for w in wins]),
                xr=np.concatenate([w.xr for w in wins]),
                x=np.concatenate([w.x for w in wins]))


def _json_state(sc):
    return json.loads(json.dumps(sc.state_dict()))


def _port_streamer(cfg, wlen, qd, channels=None):
    tcfg = TConfig(**cfg)
    if channels is None:
        return ts.StreamingCompressor(tcfg, wlen, queue_depth=qd,
                                      device="cpu")
    return ts.MVStreamingCompressor(tcfg, wlen, channels, queue_depth=qd,
                                    device="cpu")


def _port_paused_states():
    """The port's state after the first chunks of each resume case."""
    out = {}
    name, k = RESUME["uni"]
    cfg, x, cuts, qd, wlen = _case_input(name)
    sc = _port_streamer(cfg, wlen, qd)
    for c in _chunks(x, cuts)[:k]:
        sc.push(c)
    out["uni"] = _json_state(sc)
    X, cuts, wlen = _mv_input()
    sc = _port_streamer(CFG, wlen, 2, channels=X.shape[1])
    for c in _chunks(X, cuts)[:RESUME["mv"][1]]:
        sc.push(c)
    out["mv"] = _json_state(sc)
    return out


def _reference(out_dir):
    """The JAX side of every case (run in a strict-compiled subprocess):
    windows, deviations and paused states as npz/JSON in ``out_dir``."""
    with open(os.path.join(out_dir, "port_states.json")) as f:
        port_states = json.load(f)
    arrays, meta = {}, {}
    for name in CASES:
        cfg, x, cuts, qd, wlen = _case_input(name)
        sc = js.StreamingCompressor(JConfig(**cfg), wlen, queue_depth=qd)
        for k, v in _windows(_stream(sc, _chunks(x, cuts))).items():
            arrays[f"{name}/{k}"] = v
        meta[name] = dict(deviation=sc.deviation(), state=_json_state(sc))
    X, cuts, wlen = _mv_input()
    sc = js.MVStreamingCompressor(JConfig(**CFG), wlen, X.shape[1],
                                  queue_depth=2)
    for k, v in _windows(_stream(sc, _chunks(X, cuts))).items():
        arrays[f"mv/{k}"] = v
    meta["mv"] = dict(deviations=sc.deviations().tolist(),
                      state=_json_state(sc))
    # paused JAX states for the port to resume; the port's states resumed
    name, k = RESUME["uni"]
    cfg, x, cuts, qd, wlen = _case_input(name)
    sc = js.StreamingCompressor(JConfig(**cfg), wlen, queue_depth=qd)
    for c in _chunks(x, cuts)[:k]:
        sc.push(c)
    meta["paused_uni"] = _json_state(sc)
    sc = js.compressor_from_state(JConfig(**cfg), port_states["uni"])
    for key, v in _windows(
            _stream(sc, _chunks(x, cuts)[k:])).items():
        arrays[f"resumed_uni/{key}"] = v
    meta["resumed_uni"] = dict(deviation=sc.deviation())
    X, cuts, wlen = _mv_input()
    sc = js.MVStreamingCompressor(JConfig(**CFG), wlen, X.shape[1],
                                  queue_depth=2)
    for c in _chunks(X, cuts)[:RESUME["mv"][1]]:
        sc.push(c)
    meta["paused_mv"] = _json_state(sc)
    sc = js.compressor_from_state(JConfig(**CFG), port_states["mv"])
    for key, v in _windows(
            _stream(sc, _chunks(X, cuts)[RESUME["mv"][1]:])).items():
        arrays[f"resumed_mv/{key}"] = v
    meta["resumed_mv"] = dict(deviations=sc.deviations().tolist())
    np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump(meta, f)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, one_torch_thread):
    """The JAX side, computed once in a strict-compiled subprocess (after
    the port wrote the states it resumes)."""
    out = tmp_path_factory.mktemp("jax_strict_stream")
    with open(out / "port_states.json", "w") as f:
        json.dump(_port_paused_states(), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", str(out)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out / "ref.npz") as z:
        arrays = {k: z[k] for k in z.files}
    with open(out / "ref.json") as f:
        return arrays, json.load(f)


def _held(got: dict, arrays: dict, prefix: str):
    for k in ("start", "iters", "n_kept", "kept", "x"):
        np.testing.assert_array_equal(got[k], arrays[f"{prefix}/{k}"], k)
    want = arrays[f"{prefix}/xr"]
    assert got["xr"].dtype == want.dtype
    assert np.array_equal(got["xr"].view(np.uint8), want.view(np.uint8))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("name", list(CASES))
def test_stream_matches_reference(ref, name):
    arrays, meta = ref
    cfg, x, cuts, qd, wlen = _case_input(name)
    sc = _port_streamer(cfg, wlen, qd)
    wins = _stream(sc, _chunks(x, cuts))
    assert all(isinstance(w, ts.WindowResult) for w in wins)
    _held(_windows(wins), arrays, name)
    assert sc.deviation() == meta[name]["deviation"]
    if cfg.get("kappa", 1) == 4:
        # the tail: compressed with a verbatim kappa remainder, or whole
        tail = wins[-1]
        m = tail.x.shape[0]
        assert m % 4 and tail.kept[-(m % 4):].all()
        assert (tail.iters == 0) == (name == "k4_tail_verbatim")
    if cfg["mode"] == "rounds":
        assert all(w.kept[0] and w.kept[-1] for w in wins)


def test_multivariate_stream_matches_reference(ref):
    arrays, meta = ref
    X, cuts, wlen = _mv_input()
    sc = _port_streamer(CFG, wlen, 2, channels=X.shape[1])
    wins = _stream(sc, _chunks(X, cuts))
    assert all(isinstance(w, ts.MVWindowResult) for w in wins)
    _held(_windows(wins), arrays, "mv")
    np.testing.assert_array_equal(sc.deviations(), meta["mv"]["deviations"])
    assert sc.deviation() == float(sc.deviations().max())


@pytest.mark.parametrize("kind", ["uni", "mv"])
def test_state_resumes_across_packages(ref, kind):
    """A JAX state resumed by the port, and the port's state resumed by
    JAX (in the subprocess), each end bit-equal to the uninterrupted
    stream."""
    arrays, meta = ref
    if kind == "uni":
        name, k = RESUME["uni"]
        cfg, x, cuts, qd, wlen = _case_input(name)
        feed, prefix = _chunks(x, cuts), name
        assert meta["paused_uni"]["buf"], "no window queued at the pause"
    else:
        X, cuts, wlen = _mv_input()
        cfg, k, feed, prefix = CFG, RESUME["mv"][1], _chunks(X, cuts), "mv"
    sc = ts.compressor_from_state(TConfig(**cfg), meta[f"paused_{kind}"],
                                  device="cpu")
    assert sc.device.type == "cpu"
    tail = _stream(sc, feed[k:])
    # the JAX windows closed before the pause, then the port's after it
    n_before = len(arrays[f"{prefix}/start"]) - len(tail)
    starts = np.array([w.start for w in tail])
    np.testing.assert_array_equal(starts,
                                  arrays[f"{prefix}/start"][n_before:])
    got = _windows(tail)
    lo = int(starts[0]) if len(starts) else 0
    for key in ("kept", "xr"):
        want = arrays[f"{prefix}/{key}"][lo:]
        assert np.array_equal(got[key].view(np.uint8), want.view(np.uint8))
    # and JAX resumed the port's state to the same tail
    again = {k2: arrays[f"resumed_{kind}/{k2}"] for k2 in ("kept", "xr")}
    for key in ("kept", "xr"):
        assert np.array_equal(again[key].view(np.uint8),
                              got[key].view(np.uint8))
    if kind == "uni":
        assert sc.deviation() == meta[prefix]["deviation"]
        assert meta["resumed_uni"]["deviation"] == meta[prefix]["deviation"]
    else:
        np.testing.assert_array_equal(sc.deviations(),
                                      meta["mv"]["deviations"])
        np.testing.assert_array_equal(meta["resumed_mv"]["deviations"],
                                      meta["mv"]["deviations"])


def _types(v):
    if isinstance(v, dict):
        return {k: _types(u) for k, u in v.items()}
    if isinstance(v, list):
        return ["list", sorted({type(u).__name__ for u in v})]
    return type(v).__name__


def test_state_dict_keys_and_types(ref):
    """The port's state holds the reference's keys and JSON types (both
    queue and running aggregates), univariate and multivariate."""
    _, meta = ref
    name, k = RESUME["uni"]
    cfg, x, cuts, qd, wlen = _case_input(name)
    sc = _port_streamer(cfg, wlen, qd)
    for c in _chunks(x, cuts)[:k]:
        sc.push(c)
    assert _types(sc.state_dict()) == _types(meta["paused_uni"])
    assert _types(_json_state(sc)) == _types(meta["paused_uni"])
    X, cuts, wlen = _mv_input()
    sc = _port_streamer(CFG, wlen, 2, channels=X.shape[1])
    for c in _chunks(X, cuts)[:RESUME["mv"][1]]:
        sc.push(c)
    assert _types(sc.state_dict()) == _types(meta["paused_mv"])
    # a finished stream's state too
    assert (_types(meta["k1_chunked"]["state"]).keys()
            == _types(_port_streamer(CFG, W, 1).state_dict()).keys())


def test_default_compilation_kept_masks():
    """JAX's default compilation keeps the same points as the port on a
    kappa = 1 stream; its reconstructions differ from the port's only in
    the last bit of dead points (its fused multiply-add, ROADMAP C10)."""
    cfg, x, cuts, qd, wlen = _case_input("k1_chunked")
    a = js.StreamingCompressor(JConfig(**cfg), wlen, queue_depth=qd)
    b = _port_streamer(cfg, wlen, qd)
    wa, wb = (_windows(_stream(sc, _chunks(x, cuts))) for sc in (a, b))
    np.testing.assert_array_equal(wa["kept"], wb["kept"])
    np.testing.assert_array_equal(wa["xr"][wa["kept"]], wb["xr"][wb["kept"]])
    np.testing.assert_allclose(wa["xr"], wb["xr"], rtol=0,
                               atol=4 * np.spacing(np.abs(x).max()))
    assert _rel(b.deviation(), a.deviation()) <= 1e-12


def test_sequential_stream_matches_default_compilation():
    """Sequential-mode windows (queue depth 2: a drain closes its windows
    one by one) against default-compiled JAX: kept masks, starts and
    iterations equal, ``xr`` within 1e-12 (the mode accumulates it
    incrementally), deviation within 1e-12 relative."""
    cfg, x, cuts, qd, wlen = _case_input("sequential")
    a = js.StreamingCompressor(JConfig(**cfg), wlen, queue_depth=qd)
    b = _port_streamer(cfg, wlen, qd)
    wa, wb = (_windows(_stream(sc, _chunks(x, cuts))) for sc in (a, b))
    for k in ("start", "iters", "n_kept", "kept", "x"):
        np.testing.assert_array_equal(wb[k], wa[k], k)
    np.testing.assert_allclose(wb["xr"], wa["xr"], rtol=0, atol=1e-12)
    assert wa["iters"].sum() > 0
    assert _rel(b.deviation(), a.deviation()) <= 1e-12


@given(st.integers(0, 2**32 - 1), st.lists(st.integers(0, 700), max_size=6))
@settings(max_examples=4, deadline=None)
def test_chunking_invariance(seed, cuts):
    """Any push() chunking, empty and one-point chunks included, gives the
    one-chunk (``_compress_windowed``) windows bit for bit."""
    x = _series(700, seed=seed % 1000)
    ref = ts._compress_windowed(x, TConfig(**CFG), W, device="cpu")
    sc = _port_streamer(CFG, W, 1)
    got = _windows(_stream(sc, np.split(x, sorted(cuts))))
    assert np.array_equal(got["kept"], ref.kept.numpy())
    assert np.array_equal(got["xr"].view(np.uint8),
                          ref.xr.numpy().view(np.uint8))
    assert sc.deviation() == float(ref.deviation)
    assert int(ref.n_kept) == int(got["kept"].sum())


def test_queue_depth_invariance():
    """Queue depths 1, 2 and 5 (a drain is one ``compress_batch``) give the
    same windows bit for bit and the same deviation."""
    cfg, x, cuts, _, wlen = _case_input("k1_queue3")
    runs = []
    drains = []
    for qd in (1, 2, 5):
        OBS.reset()
        OBS.enable()
        try:
            sc = _port_streamer(cfg, wlen, qd)
            runs.append((_windows(_stream(sc, _chunks(x, cuts))),
                         sc.deviation()))
            drains.append(OBS.snapshot()["counters"].get(
                "cameo.batch_rounds_total", 0))
        finally:
            OBS.disable()
            OBS.reset()
    for got, dev in runs[1:]:
        for k in ("start", "kept", "xr", "iters"):
            assert np.array_equal(got[k], runs[0][0][k]), k
        assert dev == runs[0][1]
    assert drains[0] == 0 and drains[1] > 0 and drains[2] > 0


def test_running_aggregates_halo_fold():
    """Chunk-by-chunk lagged products (the halo fold through ``lag_dot``)
    equal the whole series' Eq. 7 aggregates to 1e-12, and the state
    round-trips through JSON bit for bit."""
    from repro_torch.core.acf import extract_aggregates
    y = _series(600, seed=4)
    ra = ts.RunningAggregates(8, device="cpu")
    for part in np.split(y, [100, 250, 251 + 8, 480]):
        ra.append(part)
    mid = ts.RunningAggregates.from_state(
        json.loads(json.dumps(ra.state_dict())), device="cpu")
    ra.finalize()
    mid.finalize()
    want = extract_aggregates(torch.from_numpy(y), 8)
    for a, b, c in zip(ra.aggregates(), mid.aggregates(), want):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="non-final chunk"):
        bad = ts.RunningAggregates(8, device="cpu")
        bad.append(y[:3])
        bad.append(y[3:20])


def test_validation_and_deprecated_shims():
    tcfg = TConfig(**dict(CFG, kappa=4))
    with pytest.raises(ValueError, match="not divisible"):
        ts.StreamingCompressor(tcfg, 258, device="cpu")
    with pytest.raises(ValueError, match="shorter than the minimum"):
        ts.StreamingCompressor(tcfg, 36, device="cpu")
    with pytest.raises(ValueError, match="queue_depth"):
        ts.StreamingCompressor(tcfg, 256, queue_depth=0, device="cpu")
    with pytest.raises(ValueError, match="channels"):
        ts.MVStreamingCompressor(tcfg, 256, device="cpu")
    assert ts.min_window_len(tcfg) == 40
    with pytest.warns(DeprecationWarning, match="recompile_watermark"):
        assert ts.compile_cache_size() == OBS.recompile_watermark()
    x = _series(300, 1)
    with pytest.warns(DeprecationWarning, match="differential-test oracle"):
        res = ts.compress_windowed(x, TConfig(**CFG), W, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mv = ts.compress_windowed_mv(np.stack([x, -x], 1), TConfig(**CFG), W,
                                     device="cpu")
    assert res.kept.shape == (300,) and mv.xr.shape == (300, 2)


def test_streaming_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.StreamingCompressor(TConfig(**CFG), W)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_stream_queue_depths(cuda):
    """A short stream on the card: queue depths 1 and 4 give the same
    windows bit for bit, and the running aggregates' halo folds launch
    ``lag_dot``'s kernel."""
    from repro_torch.kernels.lag_dot import lag_dot_cuda
    x = _series(4 * W + 77, seed=2)
    cuts = _cuts(x.shape[0], 3)
    runs = []
    for qd in (1, 4):
        before = lag_dot_cuda.launches
        sc = ts.StreamingCompressor(TConfig(**CFG), W, queue_depth=qd)
        runs.append(_windows(_stream(sc, _chunks(x, cuts))))
        assert lag_dot_cuda.launches > before
        assert sc.deviation() <= 1.0
    for k in ("start", "kept", "xr", "iters"):
        assert np.array_equal(runs[0][k], runs[1][k]), k


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        import jax
        jax.config.update("jax_enable_x64", True)
        _reference(sys.argv[2])
