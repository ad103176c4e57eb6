"""The ``repro_torch.api`` dataset façade — one handle for every CAMEO
workflow, on the card.

``open(path, cfg)`` returns a :class:`Dataset`, the single documented way
to ingest and query compressed time series; everything underneath
(``core.cameo`` compression, the ``CameoStore`` physical layer,
``core.streaming`` windows, ``store.query`` pushdown) is driven through it
and stays an internal detail:

* **one-shot ingest** — ``ds.write(sid, x)`` compresses and persists a
  series; a 2-D ``x [n, C]`` is a first-class **multivariate** series
  (one shared kept-index stream, per-column value streams and per-column
  ε guarantees — the v4 store layout).
* **batched ingest** — ``ds.write_batch({sid: x, ...})`` groups
  equal-length series through ``compress_batch`` (one compile, B series).
* **streaming ingest** — ``ds.stream(sid)`` returns a
  :class:`StreamWriter`: push arbitrary-size chunks, query the written
  prefix mid-stream, ``flush()`` for durability, stop and ``resume`` from
  the state stashed in the store footer.  Chunking-invariant and
  byte-identical to the one-shot windowed write.
* **reads** — ``ds.series(sid)`` returns a :class:`Series` handle:
  ``window`` decodes touch only overlapping blocks, and the pushdown
  aggregates ``sum/mean/var/acf/pacf`` come back as ``(value, bound)``
  with deterministic error bounds, answered from block metadata (Plato-
  style) without decompressing interior blocks.  On a multivariate series
  every read takes ``col=`` or returns stacked per-column answers.

The Plato-style discipline (Lin et al., VLDB'18): the handle owns both the
storage *and* the error-bounded query surface, so there is exactly one
place where a series' compression contract (ε, lags, stat, κ) lives.

Univariate operations are byte- and bit-identical to the legacy call
paths they replace (``TimeSeriesService.submit``/``ingest_stream``, free
``store.window_*`` functions, ``compress_windowed``), which now live on as
deprecated shims over the same internals.

The port's façade is the JAX package's ``repro.api`` (same files, same
journal, same answers): :func:`open` takes ``device=`` (the card unless the
caller passes ``"cpu"``; without a card it raises, never falling back), and
everything beneath it (compression, streams, block reconstructions) runs
on the store's ``device``.
"""
from __future__ import annotations

import dataclasses
import math
import os
from time import perf_counter as _perf_counter
from typing import Dict, List, Optional

import numpy as np

import torch

from repro_torch.core.acf import pacf_from_acf
from repro_torch.core.cameo import (
    CameoConfig,
    CompressResult,
    _device,
    compress,
    compress_batch,
    compress_multivariate,
)
from repro_torch.core.streaming import (
    MVStreamingCompressor,
    StreamingCompressor,
    compressor_from_state,
)
from repro_torch.obs import OBS
from repro_torch.store import query as _query
from repro_torch.store import wal as _wal
from repro_torch.store.store import DEFAULT_CACHE_BYTES, CameoStore


def open(path: str, cfg: Optional[CameoConfig] = None, *,
         mode: str = None, block_len: int = None,
         value_codec: str = None, entropy: str = None,
         cache_bytes: int = DEFAULT_CACHE_BYTES,
         store_residuals: bool = True,
         stream_window: int = 4096, wal: bool = None,
         wal_group_ms: float = _wal.DEFAULT_GROUP_MS,
         wal_group_bytes: int = _wal.DEFAULT_GROUP_BYTES,
         device="cuda") -> "Dataset":
    """Open (or create) a CAMEO dataset at ``path``.

    ``mode`` is ``"w"`` (create), ``"r"`` (read-only) or ``"a"`` (append /
    resume); the default picks ``"r"`` when the file exists, else ``"w"``.
    ``cfg`` (a :class:`~repro_torch.core.cameo.CameoConfig`) sets the
    compression contract for writes and may be omitted for read-only
    handles.
    ``store_residuals`` keeps Plato-style residual moments so value
    aggregates carry bounds vs the *original* series; ``stream_window`` is
    the default :meth:`Dataset.stream` window length.

    The store-layout parameters (``block_len``, ``value_codec``,
    ``entropy``) take effect when **creating** a file (``mode="w"``); an
    existing file keeps the settings recorded in its footer, and passing
    *different* values in ``"r"``/``"a"`` mode raises rather than
    silently ignoring them (re-passing the matching values is fine).

    Writable handles keep a per-store write-ahead journal (``wal``;
    default on, ``CAMEO_WAL=0`` opts the process out): every
    :meth:`StreamWriter.push` is acked once journaled, a crash never loses
    an acked push (``mode="a"`` recovers and replays), and the fsync
    cadence is the ``wal_group_ms`` / ``wal_group_bytes`` group-commit
    policy (see ``store/README.md`` for the durability contract).

    ``device`` is where the dataset compresses and reconstructs: the card
    unless the caller passes ``"cpu"``; without a card it raises.
    """
    _device(device)
    if mode is None:
        mode = "r" if os.path.exists(path) else "w"
    if mode not in ("r", "w", "a"):
        raise ValueError(f"unknown mode {mode!r}; use 'r', 'w' or 'a'")
    if mode != "r" and cfg is None:
        raise ValueError(f"mode {mode!r} needs a CameoConfig to write with")
    if mode == "w":
        store = CameoStore.create(
            path, block_len=4096 if block_len is None else block_len,
            value_codec=value_codec or "gorilla", entropy=entropy or "auto",
            cache_bytes=cache_bytes, wal=wal, wal_group_ms=wal_group_ms,
            wal_group_bytes=wal_group_bytes, device=device)
    else:
        store = CameoStore.open(path, mode, cache_bytes=cache_bytes,
                                wal=wal, wal_group_ms=wal_group_ms,
                                wal_group_bytes=wal_group_bytes,
                                device=device)
        clash = [f"{name}={want!r} (stored {getattr(store, name)!r})"
                 for name, want in (("block_len", block_len),
                                    ("value_codec", value_codec),
                                    ("entropy", entropy))
                 if want is not None and want != getattr(store, name)]
        if clash:
            if store._wal is not None:   # abandon without a footer rewrite
                store._wal.close()
                store._wal = None
            store._f.close()
            raise ValueError(
                f"{path!r} was created with different store-layout "
                f"settings: {', '.join(clash)}; layout parameters take "
                "effect only when creating a store (mode='w')")
    return Dataset(store, cfg, store_residuals=store_residuals,
                   stream_window=stream_window)


class Series:
    """Read handle for one stored series (obtain via ``Dataset.series``).

    ``window`` serves bit-exact reconstruction slices; the aggregate
    methods push the query down to block metadata and return
    ``(value, bound)`` with deterministic error bounds (``store/query``).
    On a multivariate series ``col`` selects one column; with ``col=None``
    aggregates come back stacked ``[C, ...]`` (one header pass serves all
    columns) and ``window`` returns ``[m, C]``.
    """

    def __init__(self, store: CameoStore, sid: str):
        if sid not in store:
            raise KeyError(f"no series {sid!r} in store")
        self._store = store
        self.sid = sid

    # -- metadata ------------------------------------------------------------

    @property
    def meta(self) -> dict:
        """The catalog entry (n, n_kept, eps, lags, deviation, bytes...)."""
        return self._store.series_meta(self.sid)

    @property
    def n(self) -> int:
        return int(self.meta["n"])

    @property
    def channels(self) -> int:
        return self._store.channels(self.sid)

    @property
    def deviation(self) -> float:
        """Recorded exact measured deviation (max over columns)."""
        return float(self.meta["deviation"])

    @property
    def deviations(self) -> np.ndarray:
        """[C] per-column recorded deviations (length 1 for univariate)."""
        return np.asarray(self.meta.get("deviations",
                                        [self.meta["deviation"]]))

    def stats(self) -> dict:
        """Byte-true compression accounting (``compression_stats``)."""
        return self._store.compression_stats(self.sid)

    # -- decodes -------------------------------------------------------------

    def window(self, a: int = None, b: int = None,
               col: int = None) -> np.ndarray:
        """Reconstruction slice ``xr[a:b]`` (whole series by default),
        bit-exact, decoding only the overlapping blocks."""
        a = 0 if a is None else a
        b = self.n if b is None else b
        return self._store.read_window(self.sid, a, b, col=col)

    def kept(self):
        """(indices, values) of the stored kept points."""
        return self._store.read_kept(self.sid)

    # -- pushdown aggregates -------------------------------------------------

    def sum(self, a: int = None, b: int = None, col: int = None):
        return _query.query(self._store, self.sid, "sum", a, b, col=col)

    def mean(self, a: int = None, b: int = None, col: int = None):
        return _query.query(self._store, self.sid, "mean", a, b, col=col)

    def var(self, a: int = None, b: int = None, col: int = None):
        return _query.query(self._store, self.sid, "var", a, b, col=col)

    def acf(self, a: int = None, b: int = None, col: int = None):
        return _query.query(self._store, self.sid, "acf", a, b, col=col)

    def pacf(self, a: int = None, b: int = None, col: int = None):
        """Window PACF with a first-order propagated deterministic bound.

        The pushdown ACF answer (exact-on-reconstruction up to its float-
        reassembly bound) is mapped through the same Durbin–Levinson
        transform the compressor uses; the bound is propagated through the
        transform's exact Jacobian (forward mode, ``torch.func.jacfwd``),
        doubled for curvature headroom — deterministic, never measured
        against a decode.  Both run in float64 on the store's device.
        """
        r, rb = self.acf(a, b, col=col)
        dev = self._store.device
        if np.ndim(r) == 2:
            vals, bounds = zip(*(_pacf_with_bound(r[c], rb[c], dev)
                                 for c in range(r.shape[0])))
            return np.asarray(vals), np.asarray(bounds)
        return _pacf_with_bound(r, rb, dev)


def _pacf_with_bound(r: np.ndarray, r_bound: np.ndarray, device):
    """``pacf_from_acf(r)`` (its own bits) and ``2 |J| r_bound + 1e-14``,
    J its Jacobian at ``r``."""
    r = torch.as_tensor(np.asarray(r, np.float64), device=device)
    rb = torch.as_tensor(np.asarray(r_bound, np.float64), device=device)
    val = pacf_from_acf(r)
    jac = torch.func.jacfwd(pacf_from_acf)(r)
    bound = 2.0 * torch.abs(jac) @ rb + 1e-14
    return val.cpu().numpy(), bound.cpu().numpy()


class StreamWriter:
    """One unbounded-feed ingest stream (obtain via ``Dataset.stream``).

    Chunks in, blocks out, O(window) state: pushes buffer into fixed
    tumbling windows, each window compresses the moment it fills (full
    per-window ε guarantee — per *column* for multivariate streams), and
    blocks hit disk the moment their border is provable.  The written
    prefix serves reads the whole time; ``flush()`` makes it durable
    (stashing resume state in the footer) and ``close()`` finalizes the
    series **byte-identical** to the one-shot windowed write of the same
    feed.  The result is chunking-invariant bit-for-bit.

    ``queue_depth`` pipelines the ingest: up to K filled windows accumulate
    and close as one batched ``[K, window]`` device program (see
    ``core/streaming.StreamingCompressor``).  Store bytes are invariant to
    the depth — windows are merely emitted in bursts — so the default of 1
    (compress each window the moment it fills) is purely a latency choice.
    """

    def __init__(self, store: CameoStore, ccfg: CameoConfig, sid: str, *,
                 window_len: int = 4096, with_resid: bool = True,
                 channels: int = 1, resume: bool = False,
                 queue_depth: int = None, block_len: int = None):
        self.sid = sid
        self._store = store
        self._wal = store._wal
        self._block_len = block_len   # per-session seal override (server)
        # journaled-but-unreplayed pushes from a crashed run (the store's
        # recovery scan parks them per-sid); consumed exactly once here
        pending = (store._wal_pending.pop(sid, None)
                   if self._wal is not None else None)
        if resume:
            entry = store._series.get(sid)
            if (entry is None or not entry.get("streaming")) and pending:
                # the crashed run journaled this stream's pushes but never
                # published a footer that catalogs it — re-create the
                # stream from scratch and let the journal replay rebuild it
                if pending[0].start != 0:
                    raise IOError(
                        f"series {sid!r}: journal replay starts at point "
                        f"{pending[0].start}, but the catalog has no "
                        "stream to resume — the journal lost its prefix")
                channels = (1 if pending[0].x.ndim == 1
                            else int(pending[0].x.shape[1]))
                self._build_fresh(store, ccfg, sid, window_len=window_len,
                                  with_resid=with_resid, channels=channels,
                                  queue_depth=queue_depth)
            else:
                self._sess = store.open_stream(sid, ccfg, resume=True,
                                               block_len=block_len)
                state = self._sess.restored_client_state
                if state is None:
                    # unwind: re-stash the session state and release the
                    # slot, so a raw-store resume of the same stream still
                    # works (and re-park the journal records)
                    store._series[sid]["stream_state"] = self._sess._stash()
                    store._streams.pop(sid, None)
                    if pending:
                        store._wal_pending[sid] = pending
                    raise ValueError(
                        f"series {sid!r}: stream was not opened through "
                        "the streaming façade — no compressor state to "
                        "resume")
                self._comp = compressor_from_state(ccfg, state,
                                                   device=store.device)
                if queue_depth is not None:   # explicit override wins
                    if queue_depth < 1:
                        raise ValueError(
                            f"queue_depth={queue_depth} must be >= 1")
                    self._comp.queue_depth = int(queue_depth)
        else:
            self._build_fresh(store, ccfg, sid, window_len=window_len,
                              with_resid=with_resid, channels=channels,
                              queue_depth=queue_depth)
        self._sess.state_provider = self._comp.state_dict
        self.closed = False
        # a fresh (non-resume) open of the same sid supersedes any crashed
        # run's journal records: they are consumed (dropped), not replayed
        if resume and pending:
            self._replay(pending)

    def _build_fresh(self, store, ccfg, sid, *, window_len, with_resid,
                     channels, queue_depth):
        if int(channels) > 1:
            self._comp = MVStreamingCompressor(
                ccfg, window_len, channels, queue_depth=queue_depth or 1,
                device=store.device)
        else:
            self._comp = StreamingCompressor(
                ccfg, window_len, queue_depth=queue_depth or 1,
                device=store.device)
        self._sess = store.open_stream(
            sid, ccfg, with_resid=with_resid, channels=channels,
            block_len=self._block_len)

    def _replay(self, pending) -> None:
        """Re-feed journaled pushes a crashed run had acked.  Replay is
        idempotent (records at or below the resumed watermark are skipped)
        and deterministic — the regenerated blocks are byte-identical to
        the ones the crashed run wrote or would have written."""
        replayed = points = 0
        for rec in pending:
            end = rec.start + int(np.shape(rec.x)[0])
            if end <= self._comp.n_seen:
                continue              # footer already covers this record
            if rec.start != self._comp.n_seen:
                raise IOError(
                    f"series {self.sid!r}: journal gap — replay record "
                    f"starts at {rec.start} but the stream resumed at "
                    f"{self._comp.n_seen}")
            self._sess.append_windows(self._comp.push(rec.x))
            replayed += 1
            points += int(np.shape(rec.x)[0])
        if OBS.enabled and replayed:
            OBS.inc("wal.replayed_records", replayed)
            OBS.inc("wal.replayed_points", points)

    # -- introspection -------------------------------------------------------

    @property
    def resume_from(self) -> int:
        """Absolute index of the next point this stream expects."""
        return self._comp.n_seen

    @property
    def n_seen(self) -> int:
        return self._comp.n_seen

    @property
    def channels(self) -> int:
        return getattr(self._comp, "channels", 1)

    def deviation(self) -> float:
        """Exact measured global deviation of the stream so far (max over
        columns for multivariate streams)."""
        return self._comp.deviation()

    def deviations(self) -> np.ndarray:
        """[C] exact per-column deviations so far."""
        if hasattr(self._comp, "deviations"):
            return self._comp.deviations()
        return np.asarray([self._comp.deviation()])

    # -- feeding -------------------------------------------------------------

    def _journal(self, chunk: np.ndarray) -> None:
        """Write-ahead: the chunk is journaled (and acked) *before* it is
        compressed, so a crash anywhere downstream replays it on resume.
        Validation happens first — a rejected chunk must never ack."""
        C = self.channels
        if C > 1:
            if chunk.ndim != 2 or int(chunk.shape[1]) != C:
                raise ValueError(
                    f"stream {self.sid!r} expects [m, {C}] chunks, got "
                    f"shape {chunk.shape}")
        elif chunk.ndim != 1:
            raise ValueError(
                f"stream {self.sid!r} expects 1-D chunks, got shape "
                f"{chunk.shape}")
        if chunk.shape[0]:
            self._wal.append_push(_wal.PushRecord(
                self.sid, self._comp.n_seen,
                np.asarray(chunk, np.float64)))

    def push(self, chunk) -> int:
        """Feed a chunk (``[m]``, or ``[m, C]`` for multivariate streams);
        compresses and stores every window it closes (one burst append per
        batched drain).  Returns the number of windows closed.

        With the journal on (the default) the push is **acked once
        journaled**: the raw points are on their way to stable storage
        (group-commit fsync cadence) before compression starts, and a
        crash at any later point replays them on ``resume`` — so a return
        from ``push`` means the data cannot be silently lost, even though
        its compressed form may not exist yet."""
        if not OBS.enabled:
            if self._wal is not None:
                self._journal(np.asarray(chunk))
            wins = self._comp.push(chunk)
            self._sess.append_windows(wins)
            return len(wins)
        t0 = _perf_counter()
        if self._wal is not None:
            self._journal(np.asarray(chunk))
            OBS.observe("ingest.ack_seconds", _perf_counter() - t0)
        wins = self._comp.push(chunk)
        self._sess.append_windows(wins)
        OBS.observe("ingest.push_seconds", _perf_counter() - t0)
        OBS.inc("ingest.points", int(np.shape(np.asarray(chunk))[0]))
        return len(wins)

    def flush(self) -> None:
        """Durability checkpoint: footer (incl. resume state) rewritten,
        fsynced, and the journal truncated to it."""
        self._sess.flush()

    def close(self) -> dict:
        """Flush the final partial window, finalize the series, and return
        its catalog entry.  On a journaling store the footer is also
        published (checkpointing the journal), so the finalized series is
        durable — not just staged for the dataset's own close."""
        self._sess.append_windows(self._comp.finish())
        if getattr(self._comp, "channels", 1) > 1:
            entry = self._sess.close(deviation=self._comp.deviation(),
                                     deviations=self._comp.deviations())
        else:
            entry = self._sess.close(deviation=self._comp.deviation())
        self.closed = True
        if self._wal is not None:
            self._store.flush()
        return entry

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # finalize only on clean exit — an exception mid-feed must leave
        # the stream incomplete (and hence resumable)
        if exc[0] is None and not self.closed:
            self.close()


class Dataset:
    """Handle over one CAMEO store file (see :func:`open`); it compresses
    on its store's ``device``."""

    def __init__(self, store: CameoStore, cfg: Optional[CameoConfig] = None,
                 *, store_residuals: bool = True, stream_window: int = 4096):
        self._store = store
        self.cfg = cfg
        self.store_residuals = bool(store_residuals)
        self.stream_window = int(stream_window)

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._store.close()

    def flush(self):
        """Make everything ingested so far durable (footer rewrite)."""
        self._store.flush()

    @property
    def writable(self) -> bool:
        return self._store._writable

    @property
    def store(self) -> CameoStore:
        """The underlying physical store (escape hatch; the façade methods
        cover the documented surface)."""
        return self._store

    def _require_write(self):
        if not self.writable:
            raise IOError("dataset opened read-only")
        if self.cfg is None:
            raise ValueError("dataset has no CameoConfig; reopen with "
                             "repro_torch.api.open(path, cfg, mode='a')")

    # -- ingest --------------------------------------------------------------

    def write(self, sid: str, x, *, eps=None) -> dict:
        """Compress and persist one series; returns its catalog entry.

        1-D ``x [n]`` stores a univariate series (bit- and byte-identical
        to the legacy compress-then-append path).  2-D ``x [n, C]`` stores
        a **multivariate** series: columns compress through
        ``compress_batch``, their kept masks union into one shared
        delta-of-delta index stream, and every column re-evaluates on the
        shared index with its exact deviation measured (and enforced)
        against the per-column ε — the v4 block layout.

        ``eps`` overrides the dataset's compression budget for this write:
        a scalar replaces ``cfg.eps``; on a multivariate series a length-C
        sequence gives **each column its own ε budget** (enforced per
        column through the repair loop; see ``compress_multivariate``).
        """
        self._require_write()
        x = np.asarray(x)
        if x.ndim == 2 and x.shape[1] == 1:
            x = x[:, 0]
        cfg = self.cfg
        eps_c = None
        if eps is not None:
            if np.ndim(eps) == 0:
                cfg = dataclasses.replace(cfg, eps=float(eps))
            elif x.ndim == 2:
                eps_c = np.asarray(eps, np.float64)
            else:
                raise ValueError(
                    "per-column eps budgets need a 2-D [n, C] series")
        if x.ndim not in (1, 2):
            raise ValueError(f"series must be [n] or [n, C], got {x.shape}")
        t0 = _perf_counter() if OBS.enabled else 0.0
        dev = self._store.device
        if x.ndim == 1:
            res = compress(x, cfg, device=dev)
        else:
            res = compress_multivariate(x, cfg, eps_c=eps_c, device=dev)
        entry = self._store.append_series(
            sid, res, cfg, x=x if self.store_residuals else None)
        if OBS.enabled:
            OBS.observe("write.seconds", _perf_counter() - t0)
            OBS.inc("write.series")
            devs = np.atleast_1d(entry.get("deviations", entry["deviation"]))
            budget = (eps_c if eps_c is not None
                      else np.full(devs.shape, cfg.eps, np.float64))
            for d, e in zip(devs, budget):
                if e and math.isfinite(e):
                    OBS.observe("write.eps_headroom", float(d) / float(e))
        return entry

    def write_batch(self, items: Dict[str, np.ndarray]) -> Dict[str, dict]:
        """Compress and persist a fleet of 1-D series, batching
        equal-length groups through ``compress_batch`` (one compile, B
        series; per-series results bit-identical to solo runs): each lane of
        the batch result is stored as a solo ``write`` would store it."""
        self._require_write()
        dev = self._store.device

        groups: Dict[int, List] = {}
        for sid, x in items.items():
            x = np.asarray(x)
            if x.ndim != 1:
                raise ValueError(
                    f"write_batch takes 1-D series ({sid!r} is {x.shape}); "
                    "use write() for multivariate data")
            groups.setdefault(x.shape[0], []).append((sid, x))
        out = {}
        for length in sorted(groups):
            group = groups[length]
            xs = np.stack([x for _, x in group])
            if self.cfg.mode == "rounds" and len(group) > 1:
                res = compress_batch(xs, self.cfg, device=dev)
                per = [CompressResult(*(f[i] for f in res))
                       for i in range(len(group))]
            else:
                per = [compress(xs[i], self.cfg, device=dev)
                       for i in range(len(group))]
            for (sid, x), r in zip(group, per):
                out[sid] = self._store.append_series(
                    sid, r, self.cfg,
                    x=x if self.store_residuals else None)
        return out

    def stream(self, sid: str, *, window_len: int = None, channels: int = 1,
               resume: bool = False, queue_depth: int = None,
               block_len: int = None) -> StreamWriter:
        """Open a continuous-feed ingest stream for ``sid``.

        ``channels > 1`` opens a multivariate stream (push ``[m, C]``
        chunks).  ``resume=True`` (on a dataset opened with ``mode="a"``)
        continues an interrupted stream from the footer-stashed state;
        feed points from ``writer.resume_from`` onward.  ``queue_depth=K``
        batches K filled windows into one device program per drain (bytes
        are invariant to the depth; default 1 compresses synchronously).
        ``block_len`` seals this stream's blocks at a non-default length
        (the ingest server seals small and compacts later — see
        ``store/maintenance.py``).
        """
        self._require_write()
        return StreamWriter(
            self._store, self.cfg, sid,
            window_len=window_len or self.stream_window,
            with_resid=self.store_residuals, channels=channels,
            resume=resume, queue_depth=queue_depth, block_len=block_len)

    # -- reads ---------------------------------------------------------------

    def series(self, sid: str) -> Series:
        return Series(self._store, sid)

    def sids(self) -> List[str]:
        return self._store.series_ids()

    def __contains__(self, sid: str) -> bool:
        return sid in self._store

    def __iter__(self):
        return iter(self._store.series_ids())

    def view(self, prefix: str) -> "DatasetView":
        """A prefix-scoped facade over this dataset: every sid passed to
        the view maps to ``prefix + sid`` in the store, and ``sids()``
        lists only (and un-prefixes) the matching series.  The ingest
        server hands out ``view(tenant + "/")`` as the tenant-scoped
        query surface; an empty prefix is the identity view."""
        return DatasetView(self, prefix)

    # -- accounting ----------------------------------------------------------

    def cache_stats(self) -> dict:
        return self._store.cache_stats()

    def stats(self, *, deep: bool = False) -> dict:
        """Whole-dataset accounting in the unified stats schema (see
        :mod:`repro_torch.obs`): ``series``, ``points``, ``n_kept``,
        ``stored_nbytes``, ``raw_nbytes``, ``point_cr``, ``bytes_cr``,
        ``cache`` — the same keys ``TimeSeriesService.stats()`` returns
        for these concepts.  Answered from the store's O(1) running
        ingest totals, so polling cost is independent of how many series
        or blocks are stored.  ``deep=True`` walks ``compression_stats``
        for every series (O(total series)) and adds the per-series dicts
        under ``per_series``."""
        t = self._store.ingest_totals()
        out = dict(
            series=t["series"], points=t["points"], n_kept=t["n_kept"],
            stored_nbytes=t["stored_nbytes"], raw_nbytes=t["raw_nbytes"],
            point_cr=t["points"] / max(t["n_kept"], 1),
            bytes_cr=t["raw_nbytes"] / max(t["stored_nbytes"], 1),
            cache=self._store.cache_stats())
        if deep:
            out["per_series"] = {s: self._store.compression_stats(s)
                                 for s in self._store.series_ids()}
        return out


class DatasetView:
    """A sid-prefix-scoped view of a :class:`Dataset` (``Dataset.view``).

    Exposes the ingest/read surface of the dataset with every series id
    transparently mapped through ``prefix + sid`` — the mechanism behind
    tenant-scoped access in :mod:`repro_torch.server` (tenant ``t`` owns the
    ``"t/"`` namespace of the shared store).  The view adds no state of
    its own: handles it returns (:class:`Series`, :class:`StreamWriter`)
    are the ordinary ones, bound to the prefixed sid.
    """

    def __init__(self, dataset: Dataset, prefix: str):
        self._ds = dataset
        self.prefix = str(prefix)

    def _sid(self, sid: str) -> str:
        return self.prefix + sid

    # -- ingest --------------------------------------------------------------

    def write(self, sid: str, x, *, eps=None) -> dict:
        return self._ds.write(self._sid(sid), x, eps=eps)

    def write_batch(self, items: Dict[str, np.ndarray]) -> Dict[str, dict]:
        out = self._ds.write_batch(
            {self._sid(sid): x for sid, x in items.items()})
        k = len(self.prefix)
        return {sid[k:]: entry for sid, entry in out.items()}

    def stream(self, sid: str, **kw) -> StreamWriter:
        return self._ds.stream(self._sid(sid), **kw)

    # -- reads ---------------------------------------------------------------

    def series(self, sid: str) -> Series:
        return self._ds.series(self._sid(sid))

    def sids(self) -> List[str]:
        k = len(self.prefix)
        return [s[k:] for s in self._ds.sids() if s.startswith(self.prefix)]

    def __contains__(self, sid: str) -> bool:
        return self._sid(sid) in self._ds

    def __iter__(self):
        return iter(self.sids())
