"""Batched time-series ingest + query service over the CameoStore.

.. deprecated:: repro_torch.api
    The service's ingest entry points (``submit``, ``ingest_stream``) are
    **deprecated shims** over the unified :mod:`repro_torch.api` façade —
    ``repro_torch.api.open(path, cfg)`` returns a ``Dataset`` whose
    ``write`` / ``write_batch`` / ``stream`` / ``series`` methods are the
    single documented surface, with first-class multivariate series.  The
    shims keep working and stay byte-identical to the façade — since the
    multi-tenant server landed they are a single-tenant wrapper over
    :class:`repro_torch.server.IngestServer` (default tenant, no
    small-block sealing, no compaction) — but new code should not use
    them.

The fleet-of-sensors front-end: producers ``submit`` raw series, the
service buffers them into length groups and drives one
``compress_batch`` per group (one round body over a lane axis, B series
on the card), then streams the results into an append-oriented
:class:`~repro_torch.store.store.CameoStore`.  Reads never wait for ingest:
window decodes and pushdown aggregates are served from the store's block
index the moment a series is flushed.

For feeds that never end, :meth:`TimeSeriesService.ingest_stream` opens a
:class:`StreamIngest` handle instead: arbitrary-size chunks stream through
a ``core/streaming.StreamingCompressor`` (window-at-a-time compression,
per-window ε guarantee) straight into a store ``StreamSession`` that
appends a block the moment its border is provable — the service holds
O(window) state per open stream, no matter how long the feed runs, and
the written prefix is queryable mid-stream.  Closing the *service*
mid-stream stashes the compressor + session state in the store footer;
reopening with ``resume=True`` and ``ingest_stream(sid, resume=True)``
continues bit-exactly (``handle.resume_from`` says which absolute index
to feed next).  The finalized series is byte-identical to compressing
the same windows one-shot (``core/streaming.compress_windowed``) and
storing them with ``append_series``.

This is the same continuous-batching-lite discipline as
``serving/engine.py``'s decode loop — slots fill, a burst runs, results
drain — applied to compression instead of token decoding.  Groups flush
automatically when ``max_batch`` series of one length are waiting;
``flush()`` drains everything (e.g. on shutdown, via the context manager).

Per-series results are bit-identical to ``compress(x, cfg)`` run alone
(see ``compress_batch``'s no-op-round guarantee), so storing through the
service changes nothing about the roundtrip contract.

Reads ride the store's decoded-block LRU (``TsServiceConfig.cache_bytes``):
repeated window decodes and pushdown edge-block decodes over hot blocks
skip bitstream decode entirely; ``stats()["cache"]`` surfaces the
hit/miss/eviction counters for capacity planning.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cameo import CameoConfig
from repro_torch.server.ingest_server import IngestServer, ServerConfig
from repro_torch.store import wal as _wal
from repro_torch.store.query import query as _pushdown_query


@dataclasses.dataclass
class TsServiceConfig:
    max_batch: int = 32           # series per compress_batch burst
    block_len: int = 4096
    value_codec: str = "gorilla"
    entropy: str = "auto"
    store_residuals: bool = True  # keep Plato-style bound metadata
    cache_bytes: int = 64 << 20   # decoded-block LRU budget (0 disables)
    stream_window: int = 4096     # default ingest_stream window length
    queue_depth: int = 1          # ingest_stream windows per batched drain
    # write-ahead journal (crash-safe ingest; see store/README.md):
    # None defers to CAMEO_WAL (default on); the group-commit policy
    # amortizes one fsync over wal_group_ms of wall clock or
    # wal_group_bytes of journal appends, whichever fills first
    wal: Optional[bool] = None
    wal_group_ms: float = _wal.DEFAULT_GROUP_MS
    wal_group_bytes: int = _wal.DEFAULT_GROUP_BYTES


class StreamIngest:
    """One unbounded-feed ingest stream: chunks in, blocks out, O(window)
    state.  A thin service-bookkeeping shim over the ingest server's
    session API (:meth:`repro_torch.server.IngestServer.session`, default
    tenant) — the same ``StreamWriter`` code path underneath, so service
    streams stay byte-identical to ``Dataset.stream`` writes.  Obtain via
    :meth:`TimeSeriesService.ingest_stream`; feed with :meth:`push` and
    :meth:`close` when the feed ends.
    """

    def __init__(self, service: "TimeSeriesService", sid: str,
                 window_len: int, resume: bool, queue_depth: int = None):
        self._svc = service
        self.sid = sid
        self._sess = service._server.session(
            sid, resume=resume, window_len=window_len,
            queue_depth=(service.scfg.queue_depth
                         if queue_depth is None else queue_depth))

    @property
    def resume_from(self) -> int:
        return self._sess.resume_from

    @property
    def n_seen(self) -> int:
        return self._sess.n_seen

    @property
    def channels(self) -> int:
        return self._sess.channels

    @property
    def closed(self) -> bool:
        return self._sess.closed

    def deviation(self) -> float:
        return self._sess.deviation()

    def deviations(self) -> np.ndarray:
        return self._sess.deviations()

    def push(self, chunk) -> int:
        return self._sess.push(chunk)

    def flush(self) -> None:
        self._sess.flush()

    def close(self) -> dict:
        entry = self._sess.close()
        self._svc._streams.pop(self.sid, None)
        self._svc._ingested += 1
        return entry

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None and not self.closed:
            self.close()


class TimeSeriesService:
    """Ingest+query front-end over one store file, on ``device`` (the card
    unless the caller passes ``"cpu"``; see :func:`repro_torch.api.open`)."""

    def __init__(self, path: str, ccfg: CameoConfig,
                 scfg: Optional[TsServiceConfig] = None, *,
                 resume: bool = False, device="cuda"):
        self.ccfg = ccfg
        self.scfg = scfg or TsServiceConfig()
        # the service is a single-tenant shim over the ingest server:
        # every entry point routes through the server's default-tenant
        # surface (seal_block_len=None, no compaction), so the stored
        # bytes stay identical to the pre-server service and to the
        # Dataset façade
        self._server = IngestServer(
            path, ccfg, ServerConfig(
                block_len=self.scfg.block_len, seal_block_len=None,
                value_codec=self.scfg.value_codec,
                entropy=self.scfg.entropy,
                cache_bytes=self.scfg.cache_bytes,
                store_residuals=self.scfg.store_residuals,
                stream_window=self.scfg.stream_window,
                queue_depth=self.scfg.queue_depth, wal=self.scfg.wal,
                wal_group_ms=self.scfg.wal_group_ms,
                wal_group_bytes=self.scfg.wal_group_bytes,
                max_sessions=1 << 30, auto_compact=False),
            resume=resume, device=device)
        self.store = self._server.store
        self._ds = self._server._ds
        # pending ingest, grouped by length (compress_batch wants [B, n])
        self._pending: Dict[int, List[Tuple[str, np.ndarray]]] = {}
        self._streams: Dict[str, StreamIngest] = {}   # open feed streams
        self._ingested = 0
        self._rounds = 0

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Drain pending batches and close the store: the footer publish
        is fsynced and checkpoints the write-ahead journal, so everything
        acked — including open streams' resume state — survives the
        shutdown even if the process dies right after."""
        self.flush()
        self._server.close()

    # -- ingest -------------------------------------------------------------

    def submit(self, sid: str, x) -> None:
        """Queue one series for compression; auto-flushes its length group
        when ``max_batch`` series are waiting.

        .. deprecated:: repro_torch.api
            Use ``repro_torch.api.open(path, cfg).write(sid, x)`` (or
            ``write_batch`` for fleets) — identical bytes, one surface.
        """
        warnings.warn(
            "TimeSeriesService.submit is deprecated; use "
            "repro_torch.api.open(...).write/write_batch",
            DeprecationWarning, stacklevel=2)
        if sid in self.store or any(
                s == sid for g in self._pending.values() for s, _ in g):
            raise ValueError(f"series {sid!r} already submitted")
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError(f"series must be 1-D, got {x.shape}")
        group = self._pending.setdefault(x.shape[0], [])
        group.append((sid, x))
        if len(group) >= self.scfg.max_batch:
            self._flush_group(x.shape[0])

    def _flush_group(self, length: int) -> None:
        group = self._pending.pop(length, [])
        if not group:
            return
        # one server call: the default-tenant write_batch drives the same
        # compress_batch-per-length-group burst and append order this
        # method used to hand-roll, so stored bytes are unchanged
        self._server.write_batch(dict(group))
        self._ingested += len(group)
        self._rounds += 1

    def flush(self) -> None:
        """Compress and store every pending series."""
        for length in sorted(self._pending):
            self._flush_group(length)

    def ingest_stream(self, sid: str, *, window_len: int = None,
                      resume: bool = False,
                      queue_depth: int = None) -> StreamIngest:
        """Open a continuous-feed ingest stream for ``sid``.

        Returns a :class:`StreamIngest`: ``push`` arbitrary chunks,
        ``close`` when the feed ends.  ``resume=True`` (on a service opened
        with ``resume=True``) continues an interrupted stream from the
        state stashed in the store footer; feed points from
        ``handle.resume_from`` onward.

        .. deprecated:: repro_torch.api
            Use ``repro_torch.api.open(path, cfg).stream(sid)`` — identical
            bytes, one surface, multivariate-capable.
        """
        warnings.warn(
            "TimeSeriesService.ingest_stream is deprecated; use "
            "repro_torch.api.open(...).stream(sid)",
            DeprecationWarning, stacklevel=2)
        if not resume and (sid in self.store or any(
                s == sid for g in self._pending.values() for s, _ in g)):
            raise ValueError(f"series {sid!r} already submitted")
        if sid in self._streams:
            raise ValueError(f"series {sid!r} already has an open stream")
        h = StreamIngest(self, sid,
                         window_len or self.scfg.stream_window, resume,
                         queue_depth)
        self._streams[sid] = h
        return h

    # -- queries ------------------------------------------------------------

    def query_window(self, sid: str, a: int, b: int) -> np.ndarray:
        """Reconstruction slice ``xr[a:b]`` (bit-exact, edge blocks only)."""
        return self.store.read_window(sid, a, b)

    def query_aggregate(self, sid: str, kind: str, a=None, b=None):
        """Pushdown aggregate ``(value, bound)``; see ``store/query.py``."""
        return _pushdown_query(self.store, sid, kind, a, b)

    def series_ids(self) -> List[str]:
        return self.store.series_ids()

    # -- accounting ---------------------------------------------------------

    def stats(self, *, deep: bool = False) -> dict:
        """Service snapshot in the unified stats schema (see
        :mod:`repro_torch.obs`): the shared keys — ``series``, ``points``,
        ``n_kept``, ``stored_nbytes``, ``raw_nbytes``, ``point_cr``,
        ``bytes_cr``, ``cache`` — match ``Dataset.stats()`` exactly, plus
        service bookkeeping (``ingested``/``pending``/``batches``/
        ``streams``).  Served from the store's O(1) running ingest totals
        — polling is constant-time regardless of how many series or
        blocks are stored.  ``deep=True`` additionally walks
        ``compression_stats`` per series into ``per_series`` (O(total
        series), the pre-telemetry behavior)."""
        out = dict(
            ingested=self._ingested,
            pending=sum(len(g) for g in self._pending.values()),
            batches=self._rounds,
            streams=len(self._streams))
        out.update(self._ds.stats(deep=deep))
        return out
