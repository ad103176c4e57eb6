"""Streaming CAMEO ingest: window-at-a-time compression with bounded state
(port of ``repro/core/streaming.py``).

The paper positions CAMEO for sensor/IoT feeds, but ``compress()`` wants the
whole series materialized.  This module is the online front-end: a
:class:`StreamingCompressor` absorbs arbitrary-size point chunks, buffers
them into fixed **tumbling windows** of ``window_len`` points, compresses
each window independently the moment it fills (through the ordinary
``compress()`` path — rounds or sequential, so every window carries the full
per-window ε guarantee), and emits the closed window as a
:class:`WindowResult`.  Peak state is O(window): one raw buffer plus O(L)
running aggregates — the Sprintz-style bounded-state discipline.

Semantics (the differential contract ``tests/test_streaming.py`` enforces):

* **Chunking invariance** — the emitted kept masks, reconstructions and the
  reported deviation are a pure function of the *stream contents* and
  ``window_len``; how the points were sliced into ``push()`` calls is
  unobservable (bit-identical results for every chunking, including the
  one-chunk case — which is exactly :func:`compress_windowed`, the one-shot
  reference).
* **Per-window fidelity** — each full window's mask/reconstruction is
  bit-identical to ``compress(x[s:s+window_len], cfg)`` on that slice; with
  ``window_len >= len(x)`` streaming therefore reproduces the one-shot
  ``compress(x, cfg)`` result exactly.
* **Exact global accounting** — the running Eq. 7 aggregates of the original
  and reconstructed target streams are maintained incrementally (O(L) state;
  the cross-window lagged products go through ``kernels/ops.lag_dot`` with a
  right-halo: the ``lag_dot`` kernel's halo form on the card, its plain
  version on the CPU).  ``deviation()`` is the exact
  measured D(S(recon), S(orig)) of the stream so far — the per-window ε
  guarantee is what is *enforced* (the paper's §4.4 local-budget discipline);
  the global deviation is *reported*, exactly as in
  ``core/parallel.compress_partitioned_local``.

Durability is the layer above's concern: this class acks nothing — a
``push()`` return only means the points are buffered/compressed in memory.
(The JAX package's serving façade journals each chunk before it reaches
the compressor; the port's façade is ROADMAP A6.)

Window borders are always kept (``compress`` never removes endpoints), so
windows concatenate without any interpolation segment crossing a border and
the stream's reconstruction is the per-window reconstructions laid side by
side.  A final partial window is compressed if its target-series length
reaches ``lags + 2`` (the shortest series the aggregate math is defined on);
anything shorter — including a tail remainder not divisible by ``kappa`` —
is kept verbatim, so the last stream point is always kept and the store's
block coverage reaches the end.

``state_dict()`` / ``from_state()`` round-trip the complete compressor state
(raw buffer + running aggregates) through JSON-safe types, bit-exactly —
the store stashes it in its footer so a closed ingest session resumes as if
it had never stopped.  The state holds exactly the JAX package's keys and
types, so a state written by either package resumes in the other.

The port's compressors run on a ``device`` (the card unless the caller
passes ``"cpu"``): the windows' compression and the running aggregates'
lagged products run there; the buffers and the running state stay numpy
on the host.  The windows' kept masks and reconstructions are numpy, as in
the JAX package.
"""
from __future__ import annotations

import math
import warnings
from time import perf_counter as _perf_counter
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.acf import Aggregates, acf_from_aggregates
from repro_torch.core.cameo import (
    CameoConfig,
    CompressResult,
    MVCompressResult,
    _device,
    _measure_fn,
    _stat_transform,
    compress,
    compress_batch,
    compress_multivariate,
    compress_rounds,
)
from repro_torch.kernels import ops as _ops
from repro_torch.obs import OBS


def compile_cache_size() -> int:
    """Deprecated shim over :func:`repro_torch.obs.recompile_watermark`.

    The streaming discipline promises *no per-length recompiles*: full
    windows and a partial tail (``compress_rounds(..., pad_to=window_len)``)
    run the same kernels.  The port compiles nothing but its CUDA kernels,
    so the watermark counts their builds (``kernels.build``): flat across
    windows once they are built.
    """
    warnings.warn(
        "compile_cache_size() is deprecated; use "
        "repro_torch.obs.recompile_watermark() (covers every registered "
        "entry point)", DeprecationWarning, stacklevel=2)
    return OBS.recompile_watermark()


def _aggregate_host(x: np.ndarray, kappa: int) -> np.ndarray:
    """The target series of a window's points, on the host.  The JAX
    package hands ``aggregate_series`` a numpy array here, which then takes
    numpy's window mean; the port takes the same, so the running
    accounting keeps the reference's bits."""
    if kappa == 1:
        return x
    return x.reshape(x.shape[0] // kappa, kappa).mean(axis=1)


def _observe_window(window_len, m, ndiv, cfg, n_kept, iters, verbatim, dev):
    """Record one closed window into the registry.  Callers hold the
    ``OBS.enabled`` guard; ``dev`` is the measured deviation (scalar,
    per-column array, or None when the window closed without one)."""
    OBS.inc("stream.windows")
    OBS.observe("stream.window_rounds", iters)
    OBS.observe("stream.window_kept_frac", n_kept / m if m else 0.0)
    if verbatim:
        OBS.inc("stream.windows_verbatim")
    elif cfg.mode == "rounds" and ndiv < window_len:
        OBS.inc("stream.pad_to_bucket_hits")
    eps = cfg.eps
    if dev is not None and eps and math.isfinite(eps):
        for d in np.atleast_1d(dev):
            OBS.observe("stream.window_eps_headroom", float(d) / eps)


class WindowResult(NamedTuple):
    """One closed stream window: ``x[start : start + len(x)]`` of the feed."""

    start: int          # absolute index of the window's first point
    x: np.ndarray       # original points of the window
    kept: np.ndarray    # bool mask (window-local)
    xr: np.ndarray      # reconstruction (kept points bit-exact)
    n_kept: int
    iters: int          # compressor rounds/removals (0 for verbatim windows)


def min_window_len(cfg: CameoConfig) -> int:
    """Shortest window the aggregate math is defined on (x-space points)."""
    return cfg.kappa * (cfg.lags + 2)


# ---------------------------------------------------------------------------
# incremental Eq. 7 aggregates of an append-only stream
# ---------------------------------------------------------------------------

class RunningAggregates:
    """Exact Eq. 7 sufficient statistics of an append-only series, O(L) state.

    The four moment rows are derived on demand from the scalar totals plus
    the stream's first/last ``L`` values (``sx(l) = T - sum(last l)``, etc. —
    the same derivation the v3 block headers use); the lagged products
    ``sxx`` are accumulated chunk-by-chunk through ``kernels/ops.lag_dot``
    with a right halo, so each lag pair ``(t, t+l)`` is owned by the chunk
    of ``t`` — identical pair-ownership to ``core/parallel``'s
    ``chunk_agg_contrib``.  A chunk's ``sxx`` contribution needs the next
    chunk's head as halo, so it is folded in one ``append`` late (or with a
    zero halo at ``finalize`` — the stream ends, so missing partners vanish).

    Only the *final* chunk may be shorter than ``L``: a short interior chunk
    could not serve as its predecessor's halo.

    The state is numpy (JSON-safe through ``state_dict``); a fold puts the
    pending chunk and its halo on ``device`` for one ``lag_dot`` call (the
    kernel's halo form on the card).
    """

    def __init__(self, L: int, backend: str = "auto", device="cuda"):
        self.L = int(L)
        self.backend = backend
        self.device = _device(device)
        self.n = 0
        self.total = 0.0
        self.total2 = 0.0
        self.head = np.empty(0, np.float64)   # first min(L, n) values
        self.tail = np.empty(0, np.float64)   # last  min(L, n) values
        self.sxx = np.zeros(self.L, np.float64)
        self._pend: Optional[np.ndarray] = None  # last chunk, awaits halo
        self._final = False

    def append(self, y) -> None:
        y = np.asarray(y, np.float64)
        if self._final:
            raise ValueError("stream already finalized")
        if y.size == 0:
            return
        if self._pend is not None:
            if self._pend.shape[0] < self.L:
                raise ValueError(
                    f"non-final chunk of {self._pend.shape[0]} < L={self.L} "
                    "values cannot anchor its successor's lag pairs")
            self.sxx = self._fold_pending(y)
        self._pend = y
        self.n += y.shape[0]
        self.total += float(y.sum())
        self.total2 += float(np.dot(y, y))
        if self.head.shape[0] < self.L:
            self.head = np.concatenate(
                [self.head, y[:self.L - self.head.shape[0]]])
        self.tail = np.concatenate([self.tail, y])[-self.L:]

    def finalize(self) -> None:
        """Fold the last pending chunk (zero halo: the stream ended)."""
        if not self._final:
            self.sxx = self._fold_pending(np.empty(0, np.float64))
            self._pend = None
            self._final = True

    def _fold_pending(self, nxt: np.ndarray) -> np.ndarray:
        """``sxx`` with the pending chunk's pairs folded in against the
        continuation ``nxt`` (non-mutating; callers assign)."""
        if self._pend is None:
            return self.sxx
        halo = np.zeros(self.L, np.float64)
        m = min(self.L, nxt.shape[0])
        halo[:m] = nxt[:m]
        dev = self.device
        return self.sxx + _ops.lag_dot(
            torch.from_numpy(self._pend).to(dev), self.L,
            halo=torch.from_numpy(halo).to(dev),
            backend=self.backend).cpu().numpy()

    def aggregates(self) -> Aggregates:
        """Eq. 7 five-tuple of the stream seen so far.  The pending chunk's
        lag pairs are folded in on the fly (zero halo — pairs reaching past
        the seen prefix don't exist yet), so the answer is exact for the
        prefix at any point, not just after :meth:`finalize`."""
        L = self.L
        l = np.arange(1, L + 1)
        valid = l < self.n
        sx = np.zeros(L)
        sxl = np.zeros(L)
        sx2 = np.zeros(L)
        sxl2 = np.zeros(L)
        if self.n:
            csh = np.cumsum(self.head)
            csh2 = np.cumsum(self.head * self.head)
            cst = np.cumsum(self.tail[::-1])
            cst2 = np.cumsum((self.tail * self.tail)[::-1])
            k = np.clip(l - 1, 0, self.tail.shape[0] - 1)
            kh = np.clip(l - 1, 0, self.head.shape[0] - 1)
            sx = np.where(valid, self.total - cst[k], 0.0)
            sx2 = np.where(valid, self.total2 - cst2[k], 0.0)
            sxl = np.where(valid, self.total - csh[kh], 0.0)
            sxl2 = np.where(valid, self.total2 - csh2[kh], 0.0)
        sxx = self._fold_pending(np.empty(0, np.float64))
        rows = [sx, sxl, sx2, sxl2, np.where(valid, sxx, 0.0)]
        return Aggregates(*(torch.as_tensor(r, dtype=torch.float64).to(
            self.device) for r in rows))

    # -- resume support ------------------------------------------------------

    def state_dict(self) -> dict:
        return dict(
            L=self.L, n=self.n, total=self.total, total2=self.total2,
            head=self.head.tolist(), tail=self.tail.tolist(),
            sxx=self.sxx.tolist(),
            pend=None if self._pend is None else self._pend.tolist(),
            final=self._final)

    @classmethod
    def from_state(cls, state: dict, backend: str = "auto", device="cuda"):
        out = cls(state["L"], backend, device)
        out.n = int(state["n"])
        out.total = float(state["total"])
        out.total2 = float(state["total2"])
        out.head = np.asarray(state["head"], np.float64)
        out.tail = np.asarray(state["tail"], np.float64)
        out.sxx = np.asarray(state["sxx"], np.float64)
        out._pend = (None if state["pend"] is None
                     else np.asarray(state["pend"], np.float64))
        out._final = bool(state["final"])
        return out


# ---------------------------------------------------------------------------
# the streaming compressor
# ---------------------------------------------------------------------------

class StreamingCompressor:
    """Window-at-a-time CAMEO over an unbounded feed; O(window) state.

    ``push(chunk)`` buffers points and returns the windows it closed (zero
    or more :class:`WindowResult`, in stream order); ``finish()`` flushes
    the final partial window.  See the module docstring for the exact
    semantics and the differential guarantees.

    ``queue_depth`` (default 1: every window compresses synchronously the
    moment it fills) lets the ingest pipeline accumulate up to K filled
    windows and close them as **one** ``compress_batch`` ``[K, window]``
    device program — a single dispatch for the whole batch, materialized
    back into per-window results in stream order.  Per-window results are
    bit-identical to the ``queue_depth=1`` path (``compress_batch``'s
    per-series no-op-round guarantee), so store bytes are invariant to the
    queue depth; windows are simply *emitted* in bursts of K.  A partial
    tail window rides the full-window compiled program via
    ``compress_rounds(..., pad_to=window_len)`` — no per-length recompiles
    (see :func:`compile_cache_size`).

    Where a deeper queue pays: on the card a round of the batched drain
    launches each kernel once for all K windows (``compress_batch``'s lane
    axis), so the host's per-launch cost is shared.

    ``device`` is where the windows compress (the card unless the caller
    passes ``"cpu"``).
    """

    def __init__(self, cfg: CameoConfig, window_len: int = 4096, *,
                 start: int = 0, queue_depth: int = 1, device="cuda"):
        if window_len % cfg.kappa:
            raise ValueError(f"window_len={window_len} not divisible by "
                             f"kappa={cfg.kappa}")
        if window_len < min_window_len(cfg):
            raise ValueError(
                f"window_len={window_len} shorter than the minimum "
                f"{min_window_len(cfg)} for lags={cfg.lags}, "
                f"kappa={cfg.kappa}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth={queue_depth} must be >= 1")
        self.cfg = cfg
        self.device = _device(device)
        self.window_len = int(window_len)
        self.queue_depth = int(queue_depth)
        self._buf = np.empty(0, np.dtype(cfg.dtype))
        self._queue: List[tuple] = []   # (start, window) awaiting batch close
        self._next_start = int(start)   # absolute index of _buf[0]
        self.n_seen = int(start)        # absolute index past the last point
        self.windows = 0
        self.n_kept = 0
        self.iters = 0
        self._finished = False
        self._orig = RunningAggregates(cfg.lags, cfg.backend, self.device)
        self._recon = RunningAggregates(cfg.lags, cfg.backend, self.device)

    # -- feeding -------------------------------------------------------------

    def push(self, chunk) -> List[WindowResult]:
        """Absorb an arbitrary-size chunk; returns the windows it closed."""
        if not OBS.enabled:
            return self._push(chunk)
        t0 = _perf_counter()
        out = self._push(chunk)
        OBS.observe("stream.push_seconds", _perf_counter() - t0)
        OBS.inc("stream.push_calls")
        OBS.gauge("stream.queue_depth", len(self._queue))
        return out

    def _push(self, chunk) -> List[WindowResult]:
        if self._finished:
            raise ValueError("stream already finished")
        chunk = np.asarray(chunk, self._buf.dtype)
        if chunk.ndim != 1:
            raise ValueError(f"chunks must be 1-D, got {chunk.shape}")
        if chunk.size:
            self._buf = np.concatenate([self._buf, chunk])
            self.n_seen += chunk.shape[0]
        out = []
        W = self.window_len
        while self._buf.shape[0] >= W:
            self._queue.append((self._next_start, self._buf[:W].copy()))
            self._buf = self._buf[W:]
            self._next_start += W
            if len(self._queue) >= self.queue_depth:
                out += self._drain()
        return out

    def finish(self) -> List[WindowResult]:
        """Flush queued windows and the final partial one; finalize."""
        if self._finished:
            return []
        out = self._drain()
        if self._buf.shape[0]:
            out.append(self._close(self._buf, final=True))
            self._next_start += self._buf.shape[0]
            self._buf = self._buf[:0]
        self._orig.finalize()
        self._recon.finalize()
        self._finished = True
        return out

    # -- window close --------------------------------------------------------

    def _drain(self) -> List[WindowResult]:
        """Close every queued full window — one ``[K, window]`` device
        program when several are waiting (rounds mode), the plain per-window
        path otherwise.  Results materialize in stream order."""
        q, self._queue = self._queue, []
        if not q:
            return []
        if OBS.enabled:
            OBS.inc("stream.queue_drains")
            OBS.observe("stream.drain_windows", len(q))
        if len(q) == 1 or self.cfg.mode != "rounds":
            return [self._close(w, final=False, start=s) for s, w in q]
        xs = np.stack([w for _, w in q])
        # one batch for all K windows
        res = compress_batch(xs, self.cfg, device=self.device)
        kept = res.kept.cpu().numpy()
        xr = res.xr.cpu().numpy()
        iters = res.iters.cpu().numpy()
        devs = res.deviation.cpu().numpy() if OBS.enabled else None
        return [self._close(w, final=False, start=s,
                            precomputed=(kept[i], xr[i], int(iters[i]),
                                         None if devs is None
                                         else float(devs[i])))
                for i, (s, w) in enumerate(q)]

    def _close(self, w_x: np.ndarray, final: bool, start: int = None,
               precomputed: tuple = None) -> WindowResult:
        cfg = self.cfg
        if start is None:
            start = self._next_start
        m = w_x.shape[0]
        ndiv = (m // cfg.kappa) * cfg.kappa
        dev = None
        verbatim = False
        if precomputed is not None:     # full window closed by a batch drain
            kept, xr, iters, dev = precomputed
        elif ndiv // cfg.kappa >= cfg.lags + 2:
            if cfg.mode == "rounds":
                # pad to the full-window bucket: a partial tail runs the
                # full window's shapes (the JAX package's compiled program)
                res = compress_rounds(w_x[:ndiv], cfg, pad_to=self.window_len,
                                      device=self.device)
            else:
                res = compress(w_x[:ndiv], cfg, device=self.device)
            kept = res.kept.cpu().numpy()
            xr = res.xr.cpu().numpy()
            iters = int(res.iters)
            if OBS.enabled:
                dev = float(res.deviation)
            if ndiv < m:    # kappa-remainder of the final window: verbatim
                kept = np.concatenate([kept, np.ones(m - ndiv, bool)])
                xr = np.concatenate([xr, w_x[ndiv:]])
        else:               # too short for the aggregate math: verbatim
            kept = np.ones(m, bool)
            xr = np.asarray(w_x).copy()
            iters = 0
            verbatim = True
        # global accounting over the kappa-divisible prefix of the stream
        if ndiv:
            self._orig.append(_aggregate_host(
                np.asarray(w_x[:ndiv], np.float64), cfg.kappa))
            self._recon.append(_aggregate_host(
                np.asarray(xr[:ndiv], np.float64), cfg.kappa))
        w = WindowResult(start=start, x=np.asarray(w_x),
                         kept=kept, xr=xr, n_kept=int(kept.sum()),
                         iters=iters)
        self.windows += 1
        self.n_kept += w.n_kept
        self.iters += iters
        if OBS.enabled:
            _observe_window(self.window_len, m, ndiv, cfg, w.n_kept,
                            iters, verbatim, dev)
        return w

    # -- exact global accounting --------------------------------------------

    def stats(self):
        """(stat_orig, stat_new): S of the original / reconstructed target
        stream so far, from the running Eq. 7 aggregates."""
        transform = _stat_transform(self.cfg)
        ny = self._orig.n
        s0 = transform(acf_from_aggregates(self._orig.aggregates(), ny))
        s1 = transform(acf_from_aggregates(self._recon.aggregates(), ny))
        return s0, s1

    def deviation(self) -> float:
        """Exact measured D(S(recon), S(orig)) over the stream so far."""
        if self._orig.n <= self.cfg.lags + 1:
            return 0.0
        s0, s1 = self.stats()
        return float(_measure_fn(self.cfg)(s1, s0))

    # -- resume support ------------------------------------------------------

    def state_dict(self) -> dict:
        """Complete state, JSON-safe and bit-exact (floats round-trip via
        repr); ``from_state`` continues as if the stream never paused.
        Queued-but-unclosed windows serialize back into the raw buffer
        (they re-queue and recompress on resume — deterministic, so the
        resumed stream stays bit-identical)."""
        buf = self._buf
        next_start = self._next_start
        if self._queue:
            buf = np.concatenate([w for _, w in self._queue] + [buf])
            next_start = self._queue[0][0]
        return dict(
            version=1, window_len=self.window_len,
            queue_depth=self.queue_depth,
            dtype=str(self._buf.dtype),
            next_start=next_start, n_seen=self.n_seen,
            windows=self.windows, n_kept=self.n_kept, iters=self.iters,
            finished=self._finished,
            buf=buf.astype(np.float64).tolist(),
            orig=self._orig.state_dict(), recon=self._recon.state_dict())

    @classmethod
    def from_state(cls, cfg: CameoConfig, state: dict, *, device="cuda"):
        out = cls(cfg, int(state["window_len"]),
                  queue_depth=int(state.get("queue_depth", 1)), device=device)
        out._buf = np.asarray(state["buf"], np.float64).astype(
            np.dtype(state["dtype"]))
        out._next_start = int(state["next_start"])
        out.n_seen = int(state["n_seen"])
        out.windows = int(state["windows"])
        out.n_kept = int(state["n_kept"])
        out.iters = int(state["iters"])
        out._finished = bool(state["finished"])
        out._orig = RunningAggregates.from_state(state["orig"], cfg.backend,
                                                 out.device)
        out._recon = RunningAggregates.from_state(state["recon"], cfg.backend,
                                                  out.device)
        # windows that were queued at pause time re-queue (the serialized
        # buffer holds them verbatim); pre-pause the queue was < queue_depth
        # deep, so re-queueing alone never triggers a drain
        W = out.window_len
        while out._buf.shape[0] >= W:
            out._queue.append((out._next_start, out._buf[:W].copy()))
            out._buf = out._buf[W:]
            out._next_start += W
        return out


# ---------------------------------------------------------------------------
# multivariate streaming: shared-index windows, per-column accounting
# ---------------------------------------------------------------------------

class MVWindowResult(NamedTuple):
    """One closed multivariate stream window (shared kept mask)."""

    start: int          # absolute index of the window's first point
    x: np.ndarray       # original points [m, C]
    kept: np.ndarray    # bool [m] — shared union mask (window-local)
    xr: np.ndarray      # reconstruction [m, C]
    n_kept: int
    iters: int


class MVStreamingCompressor:
    """Window-at-a-time multivariate CAMEO over an unbounded feed.

    The multivariate sibling of :class:`StreamingCompressor`: chunks are
    ``[m, C]``, each full window closes through
    :func:`~repro_torch.core.cameo.compress_multivariate` (per-window
    per-column ε guarantee on one shared kept index), and **per-column**
    :class:`RunningAggregates` pairs keep the exact global Eq. 7 accounting
    of every original/reconstructed column stream — ``deviations()`` is the
    exact measured per-column global deviation, O(C·L) state.  Chunking
    invariance, window-border kept points and JSON-safe bit-exact
    ``state_dict()`` resume all carry over from the univariate contract.
    """

    def __init__(self, cfg: CameoConfig, window_len: int = 4096,
                 channels: int = None, *, start: int = 0,
                 queue_depth: int = 1, device="cuda"):
        if channels is None or int(channels) < 1:
            raise ValueError("MVStreamingCompressor needs channels >= 1")
        if window_len % cfg.kappa:
            raise ValueError(f"window_len={window_len} not divisible by "
                             f"kappa={cfg.kappa}")
        if window_len < min_window_len(cfg):
            raise ValueError(
                f"window_len={window_len} shorter than the minimum "
                f"{min_window_len(cfg)} for lags={cfg.lags}, "
                f"kappa={cfg.kappa}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth={queue_depth} must be >= 1")
        self.cfg = cfg
        self.device = _device(device)
        self.window_len = int(window_len)
        self.queue_depth = int(queue_depth)
        self.channels = int(channels)
        self._buf = np.empty((0, self.channels), np.dtype(cfg.dtype))
        self._queue: List[tuple] = []   # (start, window) awaiting close
        self._next_start = int(start)
        self.n_seen = int(start)
        self.windows = 0
        self.n_kept = 0
        self.iters = 0
        self._finished = False
        self._orig = [RunningAggregates(cfg.lags, cfg.backend, self.device)
                      for _ in range(self.channels)]
        self._recon = [RunningAggregates(cfg.lags, cfg.backend, self.device)
                       for _ in range(self.channels)]

    # -- feeding -------------------------------------------------------------

    def push(self, chunk) -> List[MVWindowResult]:
        """Absorb an arbitrary-size ``[m, C]`` chunk; returns the windows
        it closed."""
        if not OBS.enabled:
            return self._push(chunk)
        t0 = _perf_counter()
        out = self._push(chunk)
        OBS.observe("stream.push_seconds", _perf_counter() - t0)
        OBS.inc("stream.push_calls")
        OBS.gauge("stream.queue_depth", len(self._queue))
        return out

    def _push(self, chunk) -> List[MVWindowResult]:
        if self._finished:
            raise ValueError("stream already finished")
        chunk = np.asarray(chunk, self._buf.dtype)
        if chunk.ndim != 2 or chunk.shape[1] != self.channels:
            raise ValueError(f"chunks must be [m, {self.channels}], "
                             f"got {chunk.shape}")
        if chunk.size:
            self._buf = np.concatenate([self._buf, chunk])
            self.n_seen += chunk.shape[0]
        out = []
        W = self.window_len
        while self._buf.shape[0] >= W:
            self._queue.append((self._next_start, self._buf[:W].copy()))
            self._buf = self._buf[W:]
            self._next_start += W
            if len(self._queue) >= self.queue_depth:
                out += self._drain()
        return out

    def finish(self) -> List[MVWindowResult]:
        if self._finished:
            return []
        out = self._drain()
        if self._buf.shape[0]:
            out.append(self._close(self._buf, final=True))
            self._next_start += self._buf.shape[0]
            self._buf = self._buf[:0]
        for ra in self._orig + self._recon:
            ra.finalize()
        self._finished = True
        return out

    # -- window close --------------------------------------------------------

    def _drain(self) -> List[MVWindowResult]:
        """Close queued windows in stream order.  Each window runs its own
        ``compress_multivariate`` (the per-column ε repair loop is inherently
        per-window); the queue still defers work so callers control when the
        device burst happens."""
        q, self._queue = self._queue, []
        if q and OBS.enabled:
            OBS.inc("stream.queue_drains")
            OBS.observe("stream.drain_windows", len(q))
        return [self._close(w, final=False, start=s) for s, w in q]

    def _close(self, w_x: np.ndarray, final: bool,
               start: int = None) -> MVWindowResult:
        cfg = self.cfg
        if start is None:
            start = self._next_start
        m = w_x.shape[0]
        ndiv = (m // cfg.kappa) * cfg.kappa
        dev = None
        verbatim = False
        if ndiv // cfg.kappa >= cfg.lags + 2:
            res = compress_multivariate(
                w_x[:ndiv], cfg,
                pad_to=self.window_len if cfg.mode == "rounds" else None,
                device=self.device)
            kept = np.asarray(res.kept)
            xr = np.asarray(res.xr)
            iters = int(res.iters)
            if OBS.enabled:
                dev = np.asarray(res.deviations)
            if ndiv < m:    # kappa-remainder of the final window: verbatim
                kept = np.concatenate([kept, np.ones(m - ndiv, bool)])
                xr = np.concatenate([xr, w_x[ndiv:]])
        else:               # too short for the aggregate math: verbatim
            kept = np.ones(m, bool)
            xr = np.asarray(w_x).copy()
            iters = 0
            verbatim = True
        if ndiv:
            for c in range(self.channels):
                self._orig[c].append(_aggregate_host(
                    np.asarray(w_x[:ndiv, c], np.float64), cfg.kappa))
                self._recon[c].append(_aggregate_host(
                    np.asarray(xr[:ndiv, c], np.float64), cfg.kappa))
        w = MVWindowResult(start=start, x=np.asarray(w_x),
                           kept=kept, xr=xr, n_kept=int(kept.sum()),
                           iters=iters)
        self.windows += 1
        self.n_kept += w.n_kept
        self.iters += iters
        if OBS.enabled:
            _observe_window(self.window_len, m, ndiv, cfg, w.n_kept,
                            iters, verbatim, dev)
        return w

    # -- exact global accounting --------------------------------------------

    def deviations(self) -> np.ndarray:
        """[C] exact measured per-column global deviation so far."""
        transform = _stat_transform(self.cfg)
        mfn = _measure_fn(self.cfg)
        out = np.zeros(self.channels)
        for c in range(self.channels):
            ny = self._orig[c].n
            if ny <= self.cfg.lags + 1:
                continue
            s0 = transform(acf_from_aggregates(
                self._orig[c].aggregates(), ny))
            s1 = transform(acf_from_aggregates(
                self._recon[c].aggregates(), ny))
            out[c] = float(mfn(s1, s0))
        return out

    def deviation(self) -> float:
        """Max per-column exact deviation (the headline number)."""
        return float(self.deviations().max()) if self.channels else 0.0

    # -- resume support ------------------------------------------------------

    def state_dict(self) -> dict:
        buf = self._buf
        next_start = self._next_start
        if self._queue:
            buf = np.concatenate([w for _, w in self._queue] + [buf])
            next_start = self._queue[0][0]
        return dict(
            version=1, kind="mvar", window_len=self.window_len,
            queue_depth=self.queue_depth,
            channels=self.channels, dtype=str(self._buf.dtype),
            next_start=next_start, n_seen=self.n_seen,
            windows=self.windows, n_kept=self.n_kept, iters=self.iters,
            finished=self._finished,
            buf=buf.astype(np.float64).tolist(),
            orig=[ra.state_dict() for ra in self._orig],
            recon=[ra.state_dict() for ra in self._recon])

    @classmethod
    def from_state(cls, cfg: CameoConfig, state: dict, *, device="cuda"):
        out = cls(cfg, int(state["window_len"]), int(state["channels"]),
                  queue_depth=int(state.get("queue_depth", 1)), device=device)
        out._buf = np.asarray(state["buf"], np.float64).reshape(
            -1, out.channels).astype(np.dtype(state["dtype"]))
        out._next_start = int(state["next_start"])
        out.n_seen = int(state["n_seen"])
        out.windows = int(state["windows"])
        out.n_kept = int(state["n_kept"])
        out.iters = int(state["iters"])
        out._finished = bool(state["finished"])
        out._orig = [RunningAggregates.from_state(s, cfg.backend, out.device)
                     for s in state["orig"]]
        out._recon = [RunningAggregates.from_state(s, cfg.backend, out.device)
                      for s in state["recon"]]
        W = out.window_len
        while out._buf.shape[0] >= W:
            out._queue.append((out._next_start, out._buf[:W].copy()))
            out._buf = out._buf[W:]
            out._next_start += W
        return out


def compressor_from_state(cfg: CameoConfig, state: dict, *, device="cuda"):
    """Rebuild the right streaming compressor (uni- or multivariate) from a
    ``state_dict()`` blob — the store footer stash does not record which
    class wrote it, the state does."""
    if state.get("kind") == "mvar":
        return MVStreamingCompressor.from_state(cfg, state, device=device)
    return StreamingCompressor.from_state(cfg, state, device=device)


# ---------------------------------------------------------------------------
# one-shot references for the streaming semantics
# ---------------------------------------------------------------------------

def _compress_windowed(x, cfg: CameoConfig, window_len: int = 4096, *,
                       device="cuda") -> CompressResult:
    x = np.asarray(x)
    sc = StreamingCompressor(cfg, window_len, device=device)
    wins = sc.push(x) + sc.finish()
    kept = np.concatenate([w.kept for w in wins])
    xr = np.concatenate([w.xr for w in wins])
    s0, s1 = sc.stats()
    dev = sc.device
    return CompressResult(
        kept=torch.from_numpy(kept).to(dev), xr=torch.from_numpy(xr).to(dev),
        deviation=torch.tensor(sc.deviation(), dtype=torch.float64,
                               device=dev),
        n_kept=torch.tensor(sc.n_kept, device=dev),
        iters=torch.tensor(sc.iters, device=dev),
        stat_orig=s0, stat_new=s1)


def compress_windowed(x, cfg: CameoConfig, window_len: int = 4096, *,
                      device="cuda") -> CompressResult:
    """One-shot windowed compression — the reference the streaming path is
    differentially tested against (it feeds the whole series as a single
    chunk, so any chunked ``push`` sequence must match it bit-for-bit).

    Returns a whole-series :class:`CompressResult`: concatenated mask and
    reconstruction, the exact measured global deviation, and the global
    stream statistics.  ``iters`` is the total across windows.

    .. deprecated::
        As in the JAX package, application code should stream through
        :class:`StreamingCompressor` (the façade, ``repro.api``, is ROADMAP
        A6); this function stays as the differential-test oracle.
    """
    warnings.warn(
        "compress_windowed is deprecated as an application entry point; "
        "use StreamingCompressor (it remains the streaming "
        "differential-test oracle)", DeprecationWarning, stacklevel=2)
    return _compress_windowed(x, cfg, window_len, device=device)


def compress_windowed_mv(X, cfg: CameoConfig, window_len: int = 4096, *,
                         device="cuda") -> MVCompressResult:
    """One-shot windowed multivariate compression — the differential
    reference for :class:`MVStreamingCompressor` (single-chunk feed)."""
    X = np.asarray(X)
    sc = MVStreamingCompressor(cfg, window_len, X.shape[1], device=device)
    wins = sc.push(X) + sc.finish()
    kept = np.concatenate([w.kept for w in wins])
    xr = np.concatenate([w.xr for w in wins])
    devs = sc.deviations()
    return MVCompressResult(
        kept=kept, xr=xr, deviation=float(devs.max()),
        n_kept=int(sc.n_kept), iters=int(sc.iters), deviations=devs,
        col_n_kept=np.full(X.shape[1], -1))
