"""``IngestServer`` — many concurrent producer streams over one store.

The server multiplexes named **tenant sessions** over a single
:class:`~repro_torch.store.store.CameoStore`:

* every mutation of the shared store happens under one re-entrant lock
  (``_lock``) — pushes from N producer threads serialize into the
  store's append discipline, so any interleaving of tenants yields
  per-series blocks, catalog entries and query answers **identical** to
  serial per-tenant ingest (the file-level block order differs; nothing
  derived from it does);
* acks ride the journaled-before-ack WAL path unchanged: a
  ``session().push()`` returns once the chunk is journaled, and after a
  crash ``IngestServer(path, ..., resume=True)`` +
  ``session(resume=True)`` replays every tenant's acked pushes
  deterministically (see ``store/README.md``);
* **admission + backpressure**: at most ``max_sessions`` sessions are
  open at once — opening one more either blocks (``backpressure=
  "block"``) or raises :class:`ServerBusy` (``"reject"``);
* per-tenant ε and point quotas come from the footer-resident tenant
  catalog (:mod:`repro_torch.server.catalog`); quota is checked *before* the
  journal write, so an over-quota push is refused, never acked;
* sessions seal small blocks (``seal_block_len``) for low-latency
  durability and the background :class:`CompactionWorker` rewrites them
  to full size on session close (``auto_compact``); the
  :class:`TierManager` moves finished series between the hot / warm /
  cold storage tiers.

``server.view(tenant)`` hands out the tenant-scoped
:class:`ServerView` query surface (reads are the plain
``DatasetView``; ingest methods route back through the server lock,
quota and admission);
``metrics_text()`` / ``metrics_app()`` expose the ``obs`` registry as a
Prometheus-style ``/metrics`` endpoint.

The port's server is the JAX package's ``repro.server`` on the card:
``IngestServer(..., device=)`` (the card unless the caller passes
``"cpu"``; without a card it raises) places its store, and with it every
compression and reconstruction, on that device.  Pushes compress under
the server lock, as the reference's do, which is what keeps the stored
bytes of concurrent sessions equal to serial ones.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.dataset import Dataset, DatasetView, Series, StreamWriter
from repro_torch.core.cameo import _device
from repro_torch.obs import OBS
from repro_torch.server.catalog import (DEFAULT_TENANT, TenantCatalog,
                                        tenant_sid)
from repro_torch.server.compaction import CompactionWorker
from repro_torch.server.tiers import TierManager
from repro_torch.store import maintenance as _maint
from repro_torch.store import wal as _wal
from repro_torch.store.store import DEFAULT_CACHE_BYTES, CameoStore


class ServerBusy(RuntimeError):
    """Session admission rejected (``backpressure="reject"`` and every
    slot is taken)."""


class QuotaExceeded(RuntimeError):
    """A push/write would take the tenant past its ``max_points`` quota
    (refused before the journal — never acked)."""


@dataclasses.dataclass
class ServerConfig:
    """Server-level knobs (the compression contract is a separate
    ``CameoConfig``).  ``seal_block_len`` is the per-session small-block
    length streams seal at (``None`` streams at the store-wide
    ``block_len`` and disables auto-compaction — nothing to merge);
    ``compact_target_len`` is the rewrite target (default: store
    ``block_len``)."""

    block_len: int = 4096
    seal_block_len: Optional[int] = None
    compact_target_len: Optional[int] = None
    value_codec: str = "gorilla"
    entropy: str = "auto"
    cache_bytes: int = DEFAULT_CACHE_BYTES
    store_residuals: bool = True
    stream_window: int = 4096
    queue_depth: int = 1
    wal: Optional[bool] = None
    wal_group_ms: float = _wal.DEFAULT_GROUP_MS
    wal_group_bytes: int = _wal.DEFAULT_GROUP_BYTES
    max_sessions: int = 64
    backpressure: str = "block"      # or "reject" -> ServerBusy
    auto_compact: bool = True


class ServerSession:
    """One tenant's open ingest stream (obtain via
    ``IngestServer.session``).  Wraps a :class:`StreamWriter`: pushes
    serialize under the server lock, quota is enforced before the
    journal ack, and ``close()`` releases the admission slot and queues
    the series for compaction."""

    def __init__(self, server: "IngestServer", tenant: str, series: str,
                 writer: StreamWriter, quota: Optional[int]):
        self._server = server
        self.tenant = tenant
        self.series = series
        self.sid = writer.sid
        self._w = writer
        self._quota = quota
        self.closed = False
        self._slot_released = False

    # -- introspection -------------------------------------------------------

    @property
    def resume_from(self) -> int:
        return self._w.resume_from

    @property
    def n_seen(self) -> int:
        return self._w.n_seen

    @property
    def channels(self) -> int:
        return self._w.channels

    def deviation(self) -> float:
        return self._w.deviation()

    def deviations(self) -> np.ndarray:
        return self._w.deviations()

    # -- feeding -------------------------------------------------------------

    def push(self, chunk) -> int:
        """Feed a chunk (journaled-before-ack; see ``StreamWriter.push``).
        Raises :class:`QuotaExceeded` *before* journaling when the chunk
        would take the tenant past its quota."""
        if self.closed:
            raise ValueError(f"session {self.tenant!r}/{self.series!r} "
                             "is closed")
        chunk = np.asarray(chunk)
        m = int(chunk.size)           # channel-expanded points
        srv = self._server
        with srv._lock:
            if self._quota is not None:
                used = srv._used_points.get(self.tenant, 0)
                if used + m > self._quota:
                    if OBS.enabled:
                        OBS.inc("server.quota_rejects")
                    raise QuotaExceeded(
                        f"tenant {self.tenant!r}: push of {m} points would "
                        f"exceed max_points={self._quota} (used {used})")
            wins = self._w.push(chunk)
            srv._used_points[self.tenant] = (
                srv._used_points.get(self.tenant, 0) + m)
        if OBS.enabled:
            OBS.inc("server.pushes")
            OBS.inc("server.points", m)
            labels = {"tenant": self.tenant or "default"}
            OBS.inc("server.tenant.pushes", labels=labels)
            OBS.inc("server.tenant.points", m, labels=labels)
        return wins

    def flush(self) -> None:
        with self._server._lock:
            self._w.flush()

    def close(self) -> dict:
        """Finalize the series (durable footer publish), release the
        admission slot, and queue the series for background compaction
        when the server seals small blocks.  The slot is released even
        when finalize fails — a failed close never shrinks admission
        capacity (the session stays in the table for a retry)."""
        srv = self._server
        try:
            with srv._lock:
                entry = self._w.close()
                srv._sessions.pop((self.tenant, self.series), None)
            self.closed = True
        finally:
            if not self._slot_released:
                self._slot_released = True
                srv._slots.release()
        if OBS.enabled:
            OBS.gauge("server.sessions", len(srv._sessions))
        if srv.cfg.auto_compact and srv.cfg.seal_block_len:
            srv._compactor.enqueue(self.sid)
        return entry

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None and not self.closed:
            self.close()


class ServerView(DatasetView):
    """Tenant-scoped facade handed out by :meth:`IngestServer.view`.

    Reads are the plain :class:`DatasetView` surface; the ingest
    methods are overridden to route back through the server, so a view
    can never bypass admission control — ``write``/``write_batch`` run
    under the server lock with the tenant quota checked *before* the
    journal append (raising :class:`QuotaExceeded`), and ``stream``
    opens a full :class:`ServerSession` (it takes an admission slot and
    accepts the ``session`` keywords: ``channels``, ``resume``,
    ``window_len``, ``queue_depth``, ``eps``)."""

    def __init__(self, server: "IngestServer", tenant: str):
        super().__init__(server._ds,
                         "" if tenant == DEFAULT_TENANT else tenant + "/")
        self._server = server
        self._tenant = tenant

    def write(self, sid: str, x, *, eps=None) -> dict:
        return self._server.write(sid, x, tenant=self._tenant, eps=eps)

    def write_batch(self, items: Dict[str, np.ndarray]) -> Dict[str, dict]:
        return self._server.write_batch(items, tenant=self._tenant)

    def stream(self, sid: str, **kw) -> ServerSession:
        return self._server.session(sid, tenant=self._tenant, **kw)


class IngestServer:
    """See module docstring.  ``resume=True`` reopens an existing store
    (``mode="a"``), recovering from the WAL if the previous run crashed;
    sessions that were open then are resumed with
    ``session(..., resume=True)``.  ``device`` is the store's (see
    :func:`repro_torch.api.open`); a card without an index is the current
    one, fixed here so the compaction thread finds the same card."""

    def __init__(self, path: str, ccfg, cfg: ServerConfig = None, *,
                 resume: bool = False, device="cuda"):
        dev = _device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg = cfg or ServerConfig()
        if cfg.backpressure not in ("block", "reject"):
            raise ValueError(
                f"backpressure={cfg.backpressure!r}; use 'block' or 'reject'")
        self.ccfg = ccfg
        self.store = CameoStore(
            path, "a" if resume else "w", block_len=cfg.block_len,
            value_codec=cfg.value_codec, entropy=cfg.entropy,
            cache_bytes=cfg.cache_bytes, wal=cfg.wal,
            wal_group_ms=cfg.wal_group_ms,
            wal_group_bytes=cfg.wal_group_bytes, device=dev)
        self._ds = Dataset(self.store, ccfg,
                           store_residuals=cfg.store_residuals,
                           stream_window=cfg.stream_window)
        self.catalog = TenantCatalog(self.store)
        self._lock = threading.RLock()
        self.tiers = TierManager(self.store, lock=self._lock)
        self._sessions: Dict[Tuple[str, str], ServerSession] = {}
        self._slots = threading.BoundedSemaphore(int(cfg.max_sessions))
        self._used_points: Dict[str, int] = {}
        self._compactor = CompactionWorker(self)
        self._closed = False

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """Drain compaction, publish the footer and close the store.
        Sessions still open are *not* finalized — their resume state is
        stashed in the footer, exactly like a store close mid-stream, so
        a later ``resume=True`` server continues them."""
        if self._closed:
            return
        self._compactor.stop()
        with self._lock:
            self._closed = True
            self.store.close()

    def flush(self) -> None:
        with self._lock:
            self.store.flush()

    def _require_open(self):
        if self._closed:
            raise ValueError("server is closed")

    # -- tenants -------------------------------------------------------------

    def register_tenant(self, tenant: str, *, eps: float = None,
                        max_points: int = None) -> dict:
        """Register/configure a tenant (namespace ``tenant + "/"``).
        Registration is control-plane: the footer is published (fsynced)
        before this returns, so a registered tenant survives any crash —
        its sessions' crash images replay into a catalog that knows it."""
        self._require_open()
        with self._lock:
            cfg = self.catalog.register(tenant, eps=eps,
                                        max_points=max_points)
            self.store.flush()
            return cfg

    def _tenant_ccfg(self, tenant: str, eps=None):
        tcfg = self.catalog.config(tenant) if tenant != DEFAULT_TENANT else {}
        e = eps if eps is not None else tcfg.get("eps")
        ccfg = self.ccfg
        if e is not None:
            ccfg = dataclasses.replace(ccfg, eps=float(e))
        return ccfg, tcfg.get("max_points")

    def _check_quota(self, tenant: str, quota: Optional[int], m: int):
        """Admit ``m`` channel-expanded points against a tenant quota
        (caller holds the lock); bumps the usage tally on success."""
        used = self._used_points.setdefault(
            tenant, self.catalog.usage(tenant)["points"]
            if self.catalog.is_registered(tenant) else 0)
        if quota is not None and used + m > quota:
            if OBS.enabled:
                OBS.inc("server.quota_rejects")
            raise QuotaExceeded(
                f"tenant {tenant!r}: {m} points would exceed "
                f"max_points={quota} (used {used})")
        self._used_points[tenant] = used + m

    # -- sessions ------------------------------------------------------------

    def session(self, series: str, *, tenant: str = DEFAULT_TENANT,
                channels: int = 1, resume: bool = False,
                window_len: int = None, queue_depth: int = None,
                eps: float = None) -> ServerSession:
        """Open (or ``resume``) one tenant's ingest stream.

        Admission: a session takes one of ``max_sessions`` slots until
        closed — the call blocks for a free slot, or raises
        :class:`ServerBusy` under ``backpressure="reject"``.  ``eps``
        overrides both the server default and the tenant's configured ε
        for this stream.
        """
        self._require_open()
        if tenant != DEFAULT_TENANT and not self.catalog.is_registered(
                tenant):
            raise KeyError(f"unknown tenant {tenant!r}; call "
                           "register_tenant first")
        if not self._slots.acquire(blocking=self.cfg.backpressure == "block"):
            if OBS.enabled:
                OBS.inc("server.rejects")
            raise ServerBusy(
                f"all {self.cfg.max_sessions} session slots are taken")
        try:
            key = (tenant, series)
            with self._lock:
                if key in self._sessions:
                    raise ValueError(
                        f"tenant {tenant!r} already has an open session "
                        f"for series {series!r}")
                ccfg, quota = self._tenant_ccfg(tenant, eps)
                # seed the quota tally before any push can race it
                self._check_quota(tenant, None, 0)
                writer = StreamWriter(
                    self.store, ccfg, tenant_sid(tenant, series),
                    window_len=window_len or self.cfg.stream_window,
                    with_resid=self.cfg.store_residuals,
                    channels=channels, resume=resume,
                    queue_depth=queue_depth or self.cfg.queue_depth,
                    block_len=self.cfg.seal_block_len)
                sess = ServerSession(self, tenant, series, writer, quota)
                self._sessions[key] = sess
            if OBS.enabled:
                OBS.gauge("server.sessions", len(self._sessions))
            return sess
        except BaseException:
            self._slots.release()
            raise

    def sessions(self) -> Dict[Tuple[str, str], ServerSession]:
        with self._lock:
            return dict(self._sessions)

    # -- one-shot ingest (the deprecated service shim routes here) ----------

    def write(self, series: str, x, *, tenant: str = DEFAULT_TENANT,
              eps=None) -> dict:
        self._require_open()
        x = np.asarray(x)
        with self._lock:
            ccfg, quota = self._tenant_ccfg(tenant, None)
            self._check_quota(tenant, quota, int(x.size))
            try:
                saved, self._ds.cfg = self._ds.cfg, ccfg
                return self._ds.write(tenant_sid(tenant, series), x, eps=eps)
            except BaseException:
                self._used_points[tenant] -= int(x.size)
                raise
            finally:
                self._ds.cfg = saved

    def write_batch(self, items: Dict[str, np.ndarray], *,
                    tenant: str = DEFAULT_TENANT) -> Dict[str, dict]:
        self._require_open()
        items = {s: np.asarray(x) for s, x in items.items()}
        m = sum(int(x.size) for x in items.values())
        with self._lock:
            ccfg, quota = self._tenant_ccfg(tenant, None)
            self._check_quota(tenant, quota, m)
            try:
                saved, self._ds.cfg = self._ds.cfg, ccfg
                out = self._ds.write_batch(
                    {tenant_sid(tenant, s): x for s, x in items.items()})
            except BaseException:
                self._used_points[tenant] -= m
                raise
            finally:
                self._ds.cfg = saved
        k = 0 if tenant == DEFAULT_TENANT else len(tenant) + 1
        return {sid[k:]: e for sid, e in out.items()}

    # -- reads ---------------------------------------------------------------

    def view(self, tenant: str = DEFAULT_TENANT) -> ServerView:
        """The tenant-scoped query/ingest facade.  Ingest methods route
        back through the server (lock + quota + admission) — see
        :class:`ServerView`."""
        if tenant != DEFAULT_TENANT and not self.catalog.is_registered(
                tenant):
            raise KeyError(f"unknown tenant {tenant!r}")
        return ServerView(self, tenant)

    def series(self, series: str, *,
               tenant: str = DEFAULT_TENANT) -> Series:
        return self._ds.series(tenant_sid(tenant, series))

    # -- maintenance ---------------------------------------------------------

    def compact(self, series: str, *, tenant: str = DEFAULT_TENANT) -> dict:
        """Synchronously compact one series (see
        ``store/maintenance.compact_series``)."""
        self._require_open()
        with self._lock:
            return _maint.compact_series(
                self.store, tenant_sid(tenant, series),
                target_len=self.cfg.compact_target_len)

    def drain_compaction(self) -> None:
        """Block until the background compaction queue is empty."""
        self._compactor.drain()

    # -- observability -------------------------------------------------------

    def metrics_text(self, prefix: str = "cameo") -> str:
        """The ``obs`` registry as Prometheus-style exposition text."""
        return OBS.exposition(prefix)

    def metrics_app(self):
        """A WSGI callable serving :meth:`metrics_text` at ``/metrics``
        (mount it under any WSGI server, e.g. ``wsgiref.simple_server``);
        other paths return 404."""
        def app(environ, start_response):
            if environ.get("PATH_INFO", "/") not in ("/metrics",
                                                     "/metrics/"):
                start_response("404 Not Found",
                               [("Content-Type",
                                 "text/plain; charset=utf-8")])
                return [b"not found\n"]
            body = self.metrics_text().encode()
            start_response("200 OK", [
                ("Content-Type",
                 "text/plain; version=0.0.4; charset=utf-8"),
                ("Content-Length", str(len(body)))])
            return [body]
        return app

    def stats(self, *, deep: bool = False) -> dict:
        """Unified dataset stats + server-level keys: open ``sessions``,
        per-``tenant`` usage, storage ``tiers``, and ``compaction``
        progress."""
        out = self._ds.stats(deep=deep)
        with self._lock:
            out["sessions"] = len(self._sessions)
            out["tenants"] = {
                t: self.catalog.usage(t)
                for t in [DEFAULT_TENANT] + self.catalog.tenants()}
        out["tiers"] = self.store.tier_stats()
        out["compaction"] = dict(compacted=self._compactor.compacted,
                                 merged_runs=self._compactor.merged_runs,
                                 last_error=self._compactor.last_error)
        return out
