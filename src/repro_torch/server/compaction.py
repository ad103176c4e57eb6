"""Background compaction worker for the ingest server.

Server stream sessions seal *small* blocks (``seal_block_len``) so a
tenant's freshly pushed points become durable and queryable with low
latency; the price is per-block header overhead and more blocks per
window.  This worker pays that debt back: when a session closes, its
sid is queued, and a daemon thread rewrites runs of small blocks into
full-size blocks via ``store/maintenance.compact_series`` — under the
server's store lock, so compaction interleaves safely with live pushes
to *other* sessions (the store's append discipline means the rewrite
never touches bytes another session could be writing).

The worker is deliberately simple and deterministic:

* one thread, one FIFO of sids (duplicates collapse);
* every rewrite is all-or-nothing via the two-phase footer publish (a
  crash mid-compaction rolls back to the pre-compaction footer — no
  torn state, because old blocks are superseded, never overwritten);
* ``drain()`` blocks until the queue is empty and the thread idle, so
  tests (and ``IngestServer.close``) can sequence deterministically;
* a failed rewrite records the error (``last_error``) and counts in
  ``obs`` rather than killing the thread.

A rewrite reconstructs blocks on the store's device from this thread (the
compressor's interpolation in PyTorch ops, no hand kernel), so on the card
the thread first makes the store's card its current device (a new thread
starts on device 0).
"""
from __future__ import annotations

import collections
import threading

import torch

from repro_torch.obs import OBS
from repro_torch.store import maintenance as _maint


class CompactionWorker:
    """FIFO compaction queue + daemon thread (see module doc)."""

    def __init__(self, server):
        self._server = server
        self._q = collections.deque()
        self._queued = set()
        self._cv = threading.Condition()
        self._stop = False
        self._busy = False
        self._thread = None
        self.compacted = 0
        self.merged_runs = 0
        self.last_error = None

    def enqueue(self, sid: str) -> None:
        with self._cv:
            if self._stop:
                return
            if sid not in self._queued:
                self._q.append(sid)
                self._queued.add(sid)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="cameo-compaction", daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def drain(self) -> None:
        """Block until every queued sid has been processed."""
        with self._cv:
            self._cv.wait_for(lambda: not self._q and not self._busy)

    def stop(self) -> None:
        """Drain, then stop the thread (idempotent)."""
        with self._cv:
            self._cv.wait_for(lambda: not self._q and not self._busy)
            self._stop = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10.0)

    def _run(self) -> None:
        dev = torch.device(self._server.store.device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._q or self._stop)
                if self._stop and not self._q:
                    return
                sid = self._q.popleft()
                self._queued.discard(sid)
                self._busy = True
            try:
                self._compact(sid)
            except Exception as e:   # noqa: BLE001 — worker must survive
                self.last_error = f"{sid}: {e}"
                if OBS.enabled:
                    OBS.inc("server.compaction.errors")
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _compact(self, sid: str) -> None:
        srv = self._server
        with srv._lock:
            if sid not in srv.store:
                return                       # superseded before we ran
            report = _maint.compact_series(
                srv.store, sid, target_len=srv.cfg.compact_target_len)
        if report["runs"]:
            self.compacted += 1
            self.merged_runs += report["runs"]
