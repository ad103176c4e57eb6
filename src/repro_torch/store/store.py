"""CameoStore — the on-disk physical layer under the compressor (port of
``repro/store/store.py``: the same bytes for the same writes).

In the JAX package application code reaches this layer through the
``repro.api`` façade, which the port does not have yet (ROADMAP A6).
Result fields may be torch tensors on any device; they become numpy here
(``_np``), and block reconstructions run on the store's ``device``.

File layout (append-oriented: blocks stream to disk as series are ingested,
the index is a footer written on ``flush``/``close``)::

    magic "CAMEOST\\x03" (or \\x04 once a multivariate block exists)
    [u32 body_len][block body + crc32] ...      (blocks, any series order)
    footer JSON (zlib)                           (series catalog)
    [u64 footer_offset][u32 footer_len][magic]

Format v3 derives the four redundant aggregate header rows from the edge
vectors + scalar moments at parse time instead of storing them (see
``store/blocks.py`` — ~2.3x further header shrink on top of the v2
shuffle+delta coding).  Format **v4** adds multivariate series — one
shared delta-of-delta kept-index stream per block, per-column value
streams and per-column Eq. 7 metadata; the v4 magic is written exactly
when the first multivariate block is (``_require_mvar`` rewrites the head
magic in place), so univariate-only files stay bit-identical to v3
writers.  v2/v3 files read fine (the per-block flags byte / catalog
``channels`` say which layout a body uses); v1 files are refused loudly —
reingest them.

Durability contract (details + journal format: ``store/README.md``)
-------------------------------------------------------------------
Writable stores keep a sidecar **write-ahead journal** (``<path>.wal``,
:mod:`repro_torch.store.wal`; opt out with ``wal=False`` / ``CAMEO_WAL=0``).
Acked stream pushes land in the journal *before* compression, with one
group-commit fsync amortized over ``wal_group_ms`` / ``wal_group_bytes``
of appends; ``flush()``/``close()`` publish the footer atomically — body
fsynced before the tail marker that makes readers trust it — and then
checkpoint (truncate) the journal.  A crashed writer leaves a file with a
torn tail: a partial block, footer, or tail marker.  ``mode="r"`` still
refuses it loudly rather than serve a partial catalog, but reopening with
``mode="a"`` **recovers**: the store rolls back to the journal's
checkpoint (the last published footer, byte-identical), and the acked
pushes past it replay deterministically through the streaming façade
(the JAX package's ``repro.api``; the port's is ROADMAP A6) — so a crash
never loses an acked push, and the recovered file is byte-identical to a clean run of
the same feed.  All fsyncs honor the ``CAMEO_FSYNC=0`` escape hatch
(tests), which downgrades power-loss durability to process-crash
durability without changing any write ordering.

Two ingest paths share the block writer:

* ``append_series`` — one shot: a finished ``CompressResult`` becomes
  blocks + a complete catalog entry.
* ``open_stream`` — a :class:`StreamSession` that absorbs closed stream
  windows (``core/streaming``) as they arrive and writes each block the
  moment its right border is provable, holding only O(block + window)
  state.  Blocks, offsets and the final footer are **byte-identical** to
  the one-shot write of the same kept points — the session replays
  ``plan_block_bounds``'s greedy rule incrementally (a border ``t1``
  commits once a kept point ``>= t1 + L`` exists, which rules out the
  tail-merge clamp).  ``flush()`` (or ``close``) rewrites the footer so
  the ingested prefix is durable and readable mid-stream; an incomplete
  session's state — pending points *and* an opaque client blob (the
  serving layer stashes its ``StreamingCompressor`` state there) — rides
  along in the footer, so reopening with ``mode="a"`` resumes the stream
  exactly where it stopped.

The reader serves random-access **window decodes** that touch only the
blocks overlapping the window (block borders are kept points, so no
interpolation segment crosses a block — see ``store/blocks.py``), plus
header-only block metadata for ``store/query.py``'s pushdown aggregates.

Reads are cached through a **byte-budgeted decoded-block LRU**
(``cache_bytes``; default 64 MiB): a hit skips the pread, the bitstream
decode *and* — once a window read has touched the block — the jitted
reconstruction, so hot windows and repeated pushdown queries run at
memcpy speed.  ``append_series`` invalidates the appended series' entries
and ``cache_stats()`` reports hits/misses/evictions for the serving layer.
Cache-miss fetches of multi-block windows coalesce blocks that sit
contiguously in the file into single preads; **read-only opens** go one
further and serve block bodies from an mmap of the file, so warm misses
are page-cache slices with no syscalls at all (``CAMEO_MMAP=0`` or
platforms without usable mmap fall back to the pread path — results are
byte-identical either way).

Roundtrip contract (tested property-style): for any compressed series,
``read_kept`` reproduces the kept mask and kept values bit-exactly, and
``read_series``/``read_window`` reproduce the canonical reconstruction —
the one-shot interpolation of the kept points — **bit-exactly**.  For the
rounds mode that canonical form *is* ``CompressResult.xr``; see
``append_series`` for the sequential mode's last-ulp caveat.  The store is
a lossless physical encoding of the compressor's lossy output.
"""
from __future__ import annotations

import collections
import json
import os
import struct
import zlib
from typing import Dict, List

import numpy as np

from repro_torch.obs import OBS
from repro_torch.store import codec as _codec
from repro_torch.store import wal as _wal
from repro_torch.store.blocks import (
    BlockMeta,
    build_block,
    build_mblock,
    parse_block,
    parse_mblock,
    plan_block_bounds,
    reconstruct_block,
)

MAGIC = b"CAMEOST\x03"
_MAGICS = {2: b"CAMEOST\x02", 3: MAGIC,   # readable format versions
           4: b"CAMEOST\x04"}             # v4 = v3 + multivariate blocks
_TAIL = struct.Struct("<QI")          # footer offset, footer byte length
DEFAULT_CACHE_BYTES = 64 << 20


def _json_default(o):
    """Footer-catalog JSON fallback: numpy scalars serialize as their exact
    Python kind.  The old ``default=float`` coerced numpy *integers* to
    float too — silently inexact past 2**53 (block offsets, ``n``, block
    borders in a large store) and wrong-typed on reload."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(
        f"footer catalog cannot serialize {type(o).__name__!r} values")

def _np(v) -> np.ndarray:
    """A result field as numpy: torch tensors, on any device, leave it
    here, at the store's edge."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


# cache-entry slots: [meta, kept_idx, kept_vals, xr_or_None, nbytes]
_E_META, _E_IDX, _E_VALS, _E_XR, _E_NBYTES = range(5)


class BlockCache:
    """Byte-budgeted LRU over decoded blocks.

    Entries hold the decoded kept points and, once a window read has needed
    it, the block's reconstruction; ``grow`` accounts the late-attached
    reconstruction bytes.  A zero budget disables caching (every ``put``
    evicts immediately), which the eviction tests rely on.

    ``pin`` marks an entry hot-tier resident: pinned entries still count
    against the budget but are skipped by eviction (the serving layer pins
    blocks of latency-critical windows; see ``server/tiers.py``).  When
    every entry is pinned the cache is allowed to run over budget rather
    than evict a pin — unpinning re-triggers eviction on the next put.
    """

    __slots__ = ("budget", "nbytes", "hits", "misses", "evictions", "_d",
                 "_pinned")

    def __init__(self, budget: int):
        self.budget = int(budget)
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._d = collections.OrderedDict()
        self._pinned = set()

    def get(self, key):
        e = self._d.get(key)
        if e is None:
            self.misses += 1
            if OBS.enabled:
                OBS.inc("store.cache.misses")
            return None
        self._d.move_to_end(key)
        self.hits += 1
        if OBS.enabled:
            OBS.inc("store.cache.hits")
        return e

    def put(self, key, entry):
        old = self._d.pop(key, None)
        if old is not None:
            self.nbytes -= old[_E_NBYTES]
        self._d[key] = entry
        self.nbytes += entry[_E_NBYTES]
        self._evict()
        if OBS.enabled:
            OBS.gauge("store.cache.nbytes", self.nbytes)

    def grow(self, key, extra: int):
        if key in self._d:
            self._d[key][_E_NBYTES] += extra
            self.nbytes += extra
            self._evict()

    def pin(self, key) -> bool:
        """Exempt a resident entry from eviction; returns False on miss."""
        if key not in self._d:
            return False
        self._pinned.add(key)
        return True

    def unpin(self, key):
        self._pinned.discard(key)

    def invalidate(self, sid: str):
        for key in [k for k in self._d if k[0] == sid]:
            self.nbytes -= self._d.pop(key)[_E_NBYTES]
            self._pinned.discard(key)

    def drop(self, key):
        """Invalidate one block entry (streamed per-append invalidation)."""
        e = self._d.pop(key, None)
        if e is not None:
            self.nbytes -= e[_E_NBYTES]
            self._pinned.discard(key)

    def clear(self):
        self._d.clear()
        self._pinned.clear()
        self.nbytes = 0

    def _evict(self):
        ev = 0
        while self.nbytes > self.budget and self._d:
            if self._pinned:
                key = next((k for k in self._d if k not in self._pinned),
                           None)
                if key is None:
                    break          # everything resident is pinned
                e = self._d.pop(key)
            else:
                _, e = self._d.popitem(last=False)
            self.nbytes -= e[_E_NBYTES]
            self.evictions += 1
            ev += 1
        if ev and OBS.enabled:
            OBS.inc("store.cache.evictions", ev)

    def stats(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    evictions=self.evictions, entries=len(self._d),
                    pinned=len(self._pinned),
                    nbytes=self.nbytes, budget=self.budget)


class CameoStore:
    """One store file: append-oriented writer + random-access reader.

    Use :meth:`create` (new file), :meth:`open` (finalized file, read-only)
    or ``open(path, mode="a")`` (resume appending).  A store created in this
    process serves reads immediately from its in-memory catalog; a reopened
    store loads the catalog from the footer.  ``cache_bytes`` budgets the
    decoded-block LRU (0 disables caching).  ``device`` is where block
    reconstructions run (the card unless the caller passes ``"cpu"``).
    """

    def __init__(self, path: str, mode: str, *, block_len: int = 4096,
                 value_codec: str = "gorilla", entropy: str = "auto",
                 cache_bytes: int = DEFAULT_CACHE_BYTES, version: int = 3,
                 wal: bool = None,
                 wal_group_ms: float = _wal.DEFAULT_GROUP_MS,
                 wal_group_bytes: int = _wal.DEFAULT_GROUP_BYTES,
                 device="cuda"):
        if value_codec not in _codec.VALUE_CODECS:
            raise ValueError(f"unknown value codec {value_codec!r}")
        if version not in _MAGICS:
            raise ValueError(f"unknown store version {version}; have "
                             f"{sorted(_MAGICS)}")
        self.path = path
        self.device = device     # where block reconstructions run
        self.block_len = int(block_len)
        self.value_codec = value_codec
        self.entropy = entropy
        self.version = int(version)
        self._series: Dict[str, dict] = {}   # sid -> catalog entry
        self._tenants: Dict[str, dict] = {}  # tenant -> config (server layer)
        self._dead_nbytes = 0    # bytes orphaned by compaction/tier rewrites
        # per-tier fetch counters (hot tier = the decoded-block LRU, whose
        # hits/misses live in cache_stats): "warm" = plain block bodies read
        # from mmap/pread, "cold" = entropy-wrapped bodies (see
        # store/maintenance.py) that pay an unwrap on top of the fetch
        self._tier_counts = dict(warm_hits=0, warm_bytes=0,
                                 cold_hits=0, cold_bytes=0)
        # O(1) running ingest totals (see ingest_totals) — bumped on every
        # append/stream emit, recomputed from the catalog on open
        self._totals = dict(series=0, points=0, n_kept=0,
                            stored_nbytes=0, raw_nbytes=0)
        self._cache = BlockCache(cache_bytes)  # (sid, bi) -> decoded entry
        self._metas: Dict[tuple, "BlockMeta"] = {}  # header-only cache
        self._streams: Dict[str, "StreamSession"] = {}  # open ingest streams
        self._writable = mode in ("w", "a")
        self._footer_dirty = False   # a footer sits at EOF; truncate first
        self._mm = None              # mmap view (lazy for writable opens)
        self._mm_stale = False       # file grew since the map was taken
        self._mm_ok = True           # mmap attempt failed; stop retrying
        self._wal = None             # WriteAheadLog of a writable store
        self._wal_pending: Dict[str, list] = {}  # journaled, un-replayed
        self._wal_group_ms = float(wal_group_ms)
        self._wal_group_bytes = int(wal_group_bytes)
        use_wal = self._writable and (
            wal if wal is not None
            else os.environ.get("CAMEO_WAL", "1") not in ("0", "false", "off"))
        if mode == "w":
            self._f = open(path, "w+b")
            self._f.write(_MAGICS[self.version])
            if use_wal:
                self._attach_wal(None)
        elif mode in ("r", "a"):
            self._f = open(path, "r+b" if mode == "a" else "rb")
            scan = (_wal.scan(self._wal_path())
                    if mode == "a" and use_wal else None)
            recovered_empty = False
            try:
                self._load_footer()
            except IOError:
                if scan is None or scan.checkpoint is None:
                    if mode != "a" and os.path.exists(self._wal_path()):
                        self._f.close()
                        raise IOError(
                            f"{self.path}: torn store with a recovery "
                            "journal alongside — reopen with mode='a' to "
                            "recover the acked prefix") from None
                    self._f.close()
                    raise
                recovered_empty = not scan.checkpoint.footer
                self._recover(scan.checkpoint)
            if mode == "r":
                self._mm = self._open_mmap()
            else:
                # defer the footer truncation to the first append: until new
                # bytes exist, the old footer (the sole copy of the catalog
                # and any stashed stream-resume state) stays intact, so a
                # crash between reopen and the first write loses nothing
                self._footer_dirty = not recovered_empty
                if use_wal:
                    self._attach_wal(scan)
        else:
            raise ValueError(f"unknown mode {mode!r}")

    # -- constructors -------------------------------------------------------

    @classmethod
    def create(cls, path: str, *, block_len: int = 4096,
               value_codec: str = "gorilla", entropy: str = "auto",
               cache_bytes: int = DEFAULT_CACHE_BYTES, version: int = 3,
               wal: bool = None,
               wal_group_ms: float = _wal.DEFAULT_GROUP_MS,
               wal_group_bytes: int = _wal.DEFAULT_GROUP_BYTES,
               device="cuda") -> "CameoStore":
        return cls(path, "w", block_len=block_len, value_codec=value_codec,
                   entropy=entropy, cache_bytes=cache_bytes, version=version,
                   wal=wal, wal_group_ms=wal_group_ms,
                   wal_group_bytes=wal_group_bytes, device=device)

    @classmethod
    def open(cls, path: str, mode: str = "r", *,
             cache_bytes: int = DEFAULT_CACHE_BYTES, wal: bool = None,
             wal_group_ms: float = _wal.DEFAULT_GROUP_MS,
             wal_group_bytes: int = _wal.DEFAULT_GROUP_BYTES,
             device="cuda") -> "CameoStore":
        return cls(path, mode, cache_bytes=cache_bytes, wal=wal,
                   wal_group_ms=wal_group_ms, wal_group_bytes=wal_group_bytes,
                   device=device)

    # -- context / lifecycle ------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._f.closed:
            return
        if self._writable:
            self._write_footer()
        if self._wal is not None:
            # the footer just published (and was fsynced) supersedes the
            # journal — except for acked pushes of streams that were never
            # resumed this run, which only the journal still holds
            self._wal.close(remove=not self._wal_pending)
            self._wal = None
        self._invalidate_mmap()
        self._f.close()

    # -- write-ahead journal ------------------------------------------------

    def _wal_path(self) -> str:
        return os.fspath(self.path) + ".wal"

    def _wal_checkpoint(self, footer: bytes = None) -> "_wal.Checkpoint":
        """Checkpoint image of the store's current published state: the
        footer bytes at EOF (or the ones just written, when passed in) and
        the layout parameters needed to rebuild an empty store."""
        meta = dict(block_len=self.block_len, value_codec=self.value_codec,
                    entropy=self.entropy)
        if footer is None:
            if self._footer_dirty and getattr(
                    self, "_footer_offset", None) is not None:
                pos = self._f.tell()
                self._f.seek(self._footer_offset)
                footer = self._f.read(self._footer_len)
                self._f.seek(pos)
            else:
                footer = b""
        off = self._footer_offset if footer else len(MAGIC)
        return _wal.Checkpoint(self.version, off, meta, footer)

    def _attach_wal(self, scan) -> None:
        """Start a journal generation for this writable store.  ``scan`` is
        the tolerant read of the previous generation (or ``None``): its
        acked pushes that the catalog does not already cover become
        ``_wal_pending`` — the streaming façade replays them on resume —
        and are carried into the new generation so they survive further
        crashes until a footer covers them."""
        pending: Dict[str, list] = {}
        if scan is not None:
            for rec in scan.pushes:
                e = self._series.get(rec.sid)
                if e is not None and not e.get("streaming"):
                    continue     # finalized after this record was acked
                pending.setdefault(rec.sid, []).append(rec)
        self._wal_pending = pending
        carry = [r for recs in pending.values() for r in recs]
        self._wal = _wal.WriteAheadLog.start(
            self._wal_path(), self._wal_checkpoint(), carry,
            group_ms=self._wal_group_ms, group_bytes=self._wal_group_bytes)

    def _recover(self, ckpt: "_wal.Checkpoint") -> None:
        """Roll a torn store file back to the journal's checkpoint image:
        truncate everything past the last published footer, restore the
        footer bytes the append run had truncated (plus tail marker and
        head magic for a crash mid-v4-upgrade), and reload the catalog.
        With no footer in the checkpoint the store rolls back to the bare
        header.  The journaled pushes past the checkpoint are *not* lost —
        they replay through the streaming façade on resume."""
        f = self._f
        end = f.seek(0, os.SEEK_END)
        if ckpt.footer:
            if end < ckpt.footer_offset:
                f.close()
                raise IOError(
                    f"{self.path}: store is shorter than its journal "
                    "checkpoint — the file lost bytes below the last "
                    "published footer; cannot recover")
            f.seek(ckpt.footer_offset)
            f.truncate()
            f.write(ckpt.footer)
            f.write(_TAIL.pack(ckpt.footer_offset, len(ckpt.footer)))
            f.write(_MAGICS[ckpt.store_version])
            f.seek(0)
            f.write(_MAGICS[ckpt.store_version])
            _wal.maybe_fsync(f)
            self._load_footer()
        else:
            f.seek(0)
            f.truncate()
            f.write(_MAGICS[ckpt.store_version])
            _wal.maybe_fsync(f)
            self.version = int(ckpt.store_version)
            self.block_len = int(ckpt.meta.get("block_len", self.block_len))
            self.value_codec = ckpt.meta.get("value_codec", self.value_codec)
            self.entropy = ckpt.meta.get("entropy", self.entropy)
            self._series = {}
            self._tenants = {}
            self._dead_nbytes = 0
            self._totals = dict(series=0, points=0, n_kept=0,
                                stored_nbytes=0, raw_nbytes=0)
        if OBS.enabled:
            OBS.inc("wal.recoveries")

    # -- mmap read path ------------------------------------------------------

    def _open_mmap(self):
        """Page-cache-backed view of the store file; ``None`` when
        disabled (``CAMEO_MMAP=0``) or unavailable (non-POSIX mmap quirks,
        empty/special files) — callers fall back to pread."""
        if os.environ.get("CAMEO_MMAP", "1").lower() in ("0", "false", "off"):
            return None
        try:
            import mmap as _mmap
            return _mmap.mmap(self._f.fileno(), 0, access=_mmap.ACCESS_READ)
        except (ImportError, AttributeError, ValueError, OSError):
            return None

    def _mmap(self):
        """The current mmap view, taken lazily.  Read-only opens map once
        at open; writable opens map on first read and **remap** after the
        file grows (``_append_body`` marks the view stale; the remap
        flushes buffered writes first so the page cache is current) —
        a reader never sees a stale or short view after an append."""
        if self._mm_stale:
            self._invalidate_mmap()
        if self._mm is None and self._writable and self._mm_ok:
            self._f.flush()
            self._mm = self._open_mmap()
            if self._mm is None:
                self._mm_ok = False   # unavailable/disabled: stop retrying
        return self._mm

    def _invalidate_mmap(self):
        """Drop the current map (before any truncation: a view over
        truncated pages would fault on access)."""
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._mm_stale = False

    def flush(self):
        """Rewrite the footer so everything ingested so far — including the
        readable prefix of open stream sessions, whose resume state is
        embedded — survives a crash: the footer body and tail marker are
        ``os.fsync``'d in order (see ``_write_footer``), so the durability
        promise holds through power loss, not just a process crash
        (``CAMEO_FSYNC=0`` downgrades it to page-cache durability for
        tests).  Appending after a flush truncates the stale footer first
        (the next flush/close writes a fresh one)."""
        if not self._writable:
            raise IOError("store opened read-only")
        self._write_footer()

    def _ensure_appendable(self):
        """Truncate a footer left at EOF by ``flush()`` before appending."""
        if self._footer_dirty:
            self._invalidate_mmap()
            self._f.seek(self._footer_offset)
            self._f.truncate()
            self._footer_dirty = False

    def _append_body(self, body: bytes) -> int:
        """Write one length-prefixed block body at EOF; returns its offset."""
        self._ensure_appendable()
        off = self._f.seek(0, os.SEEK_END)
        self._f.write(struct.pack("<I", len(body)))
        self._f.write(body)
        self._mm_stale = True   # the map no longer covers the new bytes
        if OBS.enabled:
            OBS.inc("store.write.blocks")
            OBS.inc("store.write.bytes", 4 + len(body))
        return off

    def _bump_totals(self, *, series=0, points=0, n_kept=0, stored=0):
        """Advance the O(1) running ingest totals (channel-expanded
        points; ``raw_nbytes`` is always 8 bytes/point)."""
        t = self._totals
        t["series"] += series
        t["points"] += points
        t["n_kept"] += n_kept
        t["stored_nbytes"] += stored
        t["raw_nbytes"] += 8 * points

    def _write_footer(self):
        self._ensure_appendable()
        for sid, sess in self._streams.items():
            self._series[sid]["stream_state"] = sess._stash()
        off = self._f.seek(0, os.SEEK_END)
        cat = {"block_len": self.block_len, "value_codec": self.value_codec,
               "entropy": self.entropy, "series": self._series}
        # optional keys are written only when set, so stores that never see
        # the server layer / maintenance rewrites stay byte-identical to
        # what previous writers produced
        if self._tenants:
            cat["tenants"] = self._tenants
        if self._dead_nbytes:
            cat["dead_nbytes"] = self._dead_nbytes
        footer = zlib.compress(json.dumps(
            cat, default=_json_default).encode())
        # two-phase publish: the footer body must be durable *before* the
        # tail marker that makes readers trust it — a crash between the
        # barriers leaves a torn tail (recoverable), never a tail marker
        # pointing at garbage
        self._f.write(footer)
        _wal.maybe_fsync(self._f)
        self._f.write(_TAIL.pack(off, len(footer)))
        self._f.write(_MAGICS[self.version])
        _wal.maybe_fsync(self._f)
        self._footer_offset = off
        self._footer_len = len(footer)
        self._footer_dirty = True
        if self._wal is not None:
            # the published footer is the new checkpoint; only pushes of
            # never-resumed streams still need the journal to carry them
            carry = [r for recs in self._wal_pending.values() for r in recs]
            self._wal.checkpoint(self._wal_checkpoint(footer), carry)

    def _load_footer(self):
        f = self._f
        f.seek(0)
        head = f.read(len(MAGIC))
        versions = {m: v for v, m in _MAGICS.items()}
        if head not in versions:
            if head[:-1] == MAGIC[:-1]:
                raise IOError(f"{self.path}: CameoStore format "
                              f"v{head[-1]} is not readable by this build "
                              f"(v{max(_MAGICS)}) — reingest the series "
                              "into a fresh store")
            raise IOError(f"{self.path}: not a CameoStore file")
        self.version = versions[head]
        end = f.seek(0, os.SEEK_END)
        tail_len = _TAIL.size + len(MAGIC)
        if end < len(MAGIC) + tail_len:
            raise IOError(f"{self.path}: truncated store (no footer)")
        f.seek(end - tail_len)
        tail = f.read(tail_len)
        if tail[-len(MAGIC):] != head:
            raise IOError(f"{self.path}: missing footer magic — the writer "
                          "crashed mid-run; reopen with mode='a' to recover "
                          "from the journal, or reingest")
        off, flen = _TAIL.unpack(tail[:_TAIL.size])
        f.seek(off)
        try:
            meta = json.loads(zlib.decompress(f.read(flen)).decode())
        except Exception as e:   # garbage tail pointer / torn footer bytes
            raise IOError(
                f"{self.path}: corrupt footer ({e}); reopen with mode='a' "
                "to recover from the journal, or reingest") from None
        self._footer_len = flen
        self.block_len = int(meta.get("block_len", self.block_len))
        self.value_codec = meta.get("value_codec", self.value_codec)
        self.entropy = meta.get("entropy", self.entropy)
        self._series = meta["series"]
        self._tenants = meta.get("tenants", {})
        self._dead_nbytes = int(meta.get("dead_nbytes", 0))
        self._footer_offset = off
        t = self._totals = dict(series=0, points=0, n_kept=0,
                                stored_nbytes=0, raw_nbytes=0)
        for e in self._series.values():   # one O(series) pass at open
            C = int(e.get("channels", 1))
            t["series"] += 1
            t["points"] += e["n"] * C
            t["n_kept"] += e["n_kept"] * C
            t["stored_nbytes"] += e["stored_nbytes"]
            t["raw_nbytes"] += 8 * e["n"] * C

    # -- ingest -------------------------------------------------------------

    def _check_mvar_writable(self):
        """Validate (without touching the file) that this store's format
        can hold multivariate series."""
        if self.version < 3:
            raise ValueError(
                "multivariate series need a v3+ store (the v2 compat "
                "format is univariate-only)")

    def _require_mvar(self):
        """Flip the file format to v4 at the first multivariate block.

        Files that only ever hold univariate series keep the v3 magic and
        stay bit-identical to pre-v4 writers; the upgrade (head magic
        rewritten in place, footer magic follows ``self.version``) happens
        exactly when the first multivariate block is written.  Ordering
        matters for crash safety: any stale footer is truncated *before*
        the head magic flips, so a crash mid-upgrade leaves a file that is
        already recognizably mid-write (no footer) — never an intact v3
        footer behind a v4 head, which ``_load_footer``'s tail==head check
        would refuse even though the old catalog was still good.
        """
        self._check_mvar_writable()
        if self.version < 4:
            self._ensure_appendable()
            self.version = 4
            self._f.seek(0)
            self._f.write(_MAGICS[4])

    @property
    def _block_meta_version(self) -> int:
        """Univariate block layout version (v4 files still write v3
        univariate block bodies — v4 only adds the multivariate layout)."""
        return min(self.version, 3)

    def _mvar_body(self, kept_idx, kept_vals, *, t0: int, t1: int,
                   is_last: bool, dtype: str, cfg, x64, x_off: int = 0):
        """Encode one multivariate block: per-column canonical
        reconstructions over the owned range + optional residual moments.
        Shared by ``append_series`` and ``StreamSession`` so streamed and
        one-shot multivariate files stay byte-identical."""
        self._require_mvar()
        o1 = t1 + 1 if is_last else t1
        C = kept_vals.shape[1]
        owned = np.stack(
            [reconstruct_block(kept_idx - t0,
                               np.ascontiguousarray(kept_vals[:, c]),
                               t1 - t0 + 1, dtype, self.device)[:o1 - t0]
             for c in range(C)], axis=1)
        resid = None if x64 is None else x64[t0 - x_off:o1 - x_off] - owned
        return build_mblock(
            kept_idx, kept_vals, t0=t0, t1=t1, is_last=is_last,
            owned_xr=owned, L=cfg.lags, kappa=cfg.kappa, stat=cfg.stat,
            eps=cfg.eps, resid=resid, value_codec=self.value_codec,
            entropy=self.entropy)

    def _append_multivariate(self, sid: str, res, cfg, X=None) -> dict:
        """Write one multivariate series (see ``append_series``)."""
        kept = _np(res.kept)
        xr = _np(res.xr)
        n, C = xr.shape
        self._check_mvar_writable()
        kept_idx = np.nonzero(kept)[0].astype(np.int64)
        kept_vals = np.ascontiguousarray(xr[kept_idx])
        x64 = None if X is None else _np(X).astype(np.float64)[:n]
        bounds = plan_block_bounds(kept_idx, self.block_len, cfg.lags)
        devs = np.asarray(getattr(res, "deviations",
                                  np.full(C, float(res.deviation))),
                          np.float64)

        blocks: List[dict] = []
        nbytes = payload_nbytes = meta_nbytes = meta_raw_nbytes = 0
        for bi in range(len(bounds) - 1):
            t0, t1 = bounds[bi], bounds[bi + 1]
            is_last = bi == len(bounds) - 2
            sel = (kept_idx >= t0) & (kept_idx <= t1)
            body, binfo = self._mvar_body(
                kept_idx[sel], kept_vals[sel], t0=t0, t1=t1,
                is_last=is_last, dtype=str(xr.dtype), cfg=cfg, x64=x64)
            off = self._append_body(body)
            nbytes += 4 + len(body)
            payload_nbytes += binfo["payload_nbytes"]
            meta_nbytes += binfo["meta_nbytes"]
            meta_raw_nbytes += binfo["meta_raw_nbytes"]
            blocks.append(dict(offset=off, nbytes=len(body), t0=t0, t1=t1))
        self._f.flush()
        entry = dict(
            n=n, n_kept=int(kept_idx.shape[0]), dtype=str(xr.dtype),
            eps=float(cfg.eps), stat=cfg.stat, lags=int(cfg.lags),
            kappa=int(cfg.kappa), deviation=float(res.deviation),
            value_codec=self.value_codec, stored_nbytes=nbytes,
            payload_nbytes=payload_nbytes,
            meta_nbytes=meta_nbytes, meta_raw_nbytes=meta_raw_nbytes,
            has_resid=x64 is not None, channels=C,
            deviations=[float(d) for d in devs], blocks=blocks)
        self._series[sid] = entry
        self._bump_totals(series=1, points=n * C,
                          n_kept=entry["n_kept"] * C, stored=nbytes)
        self._cache.invalidate(sid)
        for key in [k for k in self._metas if k[0] == sid]:
            del self._metas[key]
        return entry

    def append_series(self, sid: str, res, cfg, x=None) -> dict:
        """Write one compressed series.

        ``res`` is a ``CompressResult`` (anything with ``.kept`` / ``.xr``
        works), ``cfg`` the ``CameoConfig`` it was produced under, and ``x``
        optionally the *original* series — when given, per-block residual
        moments are stored and pushdown value aggregates carry deterministic
        error bounds **vs the original** (otherwise vs the reconstruction).
        Returns the catalog entry (byte sizes, per-block extents).  Any
        cached decoded blocks for ``sid`` are invalidated.

        The stored reconstruction is the *canonical* one-shot interpolation
        of the kept points (the paper's §4.1 decompression), computed here
        per block so the write-time metadata is self-consistent with every
        future decode.  For the rounds mode this is bit-identical to
        ``res.xr``; the sequential mode's ``xr`` is accumulated incrementally
        during compression, so its dead positions can differ from the
        canonical interpolation in the last ulp — kept points are bit-exact
        either way.
        """
        if not self._writable:
            raise IOError("store opened read-only")
        if sid in self._series:
            raise ValueError(f"series {sid!r} already stored")
        kept = _np(res.kept)
        xr = _np(res.xr)
        if xr.ndim == 2:
            return self._append_multivariate(sid, res, cfg, X=x)
        n = int(kept.shape[0])
        kept_idx = np.nonzero(kept)[0].astype(np.int64)
        x64 = None if x is None else _np(x).astype(np.float64)[:n]
        bounds = plan_block_bounds(kept_idx, self.block_len, cfg.lags)

        blocks: List[dict] = []
        nbytes = payload_nbytes = meta_nbytes = meta_raw_nbytes = 0
        for bi in range(len(bounds) - 1):
            t0, t1 = bounds[bi], bounds[bi + 1]
            is_last = bi == len(bounds) - 2
            o1 = t1 + 1 if is_last else t1
            sel = (kept_idx >= t0) & (kept_idx <= t1)
            bidx, bvals = kept_idx[sel], xr[kept_idx[sel]]
            owned_xr = reconstruct_block(
                bidx - t0, bvals, t1 - t0 + 1, str(xr.dtype),
                self.device)[:o1 - t0]
            body, binfo = build_block(
                bidx, bvals, t0=t0, t1=t1,
                is_last=is_last, owned_xr=owned_xr,
                L=cfg.lags, kappa=cfg.kappa, stat=cfg.stat, eps=cfg.eps,
                resid=None if x64 is None else x64[t0:o1] - owned_xr,
                value_codec=self.value_codec, entropy=self.entropy,
                meta_version=self._block_meta_version)
            off = self._append_body(body)
            nbytes += 4 + len(body)
            payload_nbytes += binfo["payload_nbytes"]
            meta_nbytes += binfo["meta_nbytes"]
            meta_raw_nbytes += binfo["meta_raw_nbytes"]
            blocks.append(dict(offset=off, nbytes=len(body), t0=t0, t1=t1))
        self._f.flush()
        entry = dict(
            n=n, n_kept=int(kept_idx.shape[0]), dtype=str(xr.dtype),
            eps=float(cfg.eps), stat=cfg.stat, lags=int(cfg.lags),
            kappa=int(cfg.kappa), deviation=float(res.deviation),
            value_codec=self.value_codec, stored_nbytes=nbytes,
            payload_nbytes=payload_nbytes,
            meta_nbytes=meta_nbytes, meta_raw_nbytes=meta_raw_nbytes,
            has_resid=x64 is not None, blocks=blocks)
        self._series[sid] = entry
        self._bump_totals(series=1, points=n, n_kept=entry["n_kept"],
                          stored=nbytes)
        self._cache.invalidate(sid)
        for key in [k for k in self._metas if k[0] == sid]:
            del self._metas[key]
        return entry

    def open_stream(self, sid: str, cfg, *, dtype: str = None,
                    with_resid: bool = True, channels: int = 1,
                    resume: bool = False,
                    block_len: int = None) -> "StreamSession":
        """Open a streaming append session for one series.

        The session absorbs closed stream windows (``StreamSession.append``
        / ``append_window``) and writes blocks incrementally; the series is
        queryable over its written prefix the whole time and finalizes on
        ``StreamSession.close``.  With ``resume=True`` the session continues
        an incomplete stream from the state stashed in the footer by a
        previous ``flush()``/store close (open the store with ``mode="a"``).

        ``with_resid`` stores Plato-style residual moments (the appended
        windows then carry the original points, which they do by
        construction).  The finalized series — blocks, offsets, catalog
        entry — is byte-identical to a one-shot ``append_series`` of the
        same kept points.

        ``block_len`` overrides the store-wide block length for this
        session only (the ingest server seals small low-latency blocks per
        stream and lets the compaction worker rewrite them to full size
        later — see ``store/maintenance.py``).  The override rides along in
        the resume stash, so a resumed session keeps sealing at the same
        length.
        """
        if not self._writable:
            raise IOError("store opened read-only")
        if resume:
            entry = self._series.get(sid)
            if entry is None or not entry.get("streaming"):
                raise ValueError(
                    f"series {sid!r} has no incomplete stream to resume")
            if sid in self._streams:
                raise ValueError(f"series {sid!r} already has an open "
                                 "stream session")
            # validate before consuming the stash: a failed resume attempt
            # (wrong cfg) must leave the stream resumable with the right one
            for key, want in (("eps", float(cfg.eps)), ("stat", cfg.stat),
                              ("lags", int(cfg.lags)),
                              ("kappa", int(cfg.kappa))):
                if entry[key] != want:
                    raise ValueError(
                        f"series {sid!r}: resume cfg mismatch on {key}: "
                        f"stored {entry[key]!r} vs {want!r}")
            stash = entry.pop("stream_state", None)
            if stash is None:
                raise ValueError(
                    f"series {sid!r}: no stream state stashed — the "
                    "previous writer crashed before flush()/close")
            sess = StreamSession(self, sid, cfg, dtype=stash["dtype"],
                                 with_resid=stash["with_resid"],
                                 entry=entry, stash=stash,
                                 block_len=block_len)
        else:
            if sid in self._series:
                raise ValueError(f"series {sid!r} already stored")
            dtype = dtype or getattr(cfg, "dtype", "float64")
            entry = dict(
                n=0, n_kept=0, dtype=str(np.dtype(dtype)),
                eps=float(cfg.eps), stat=cfg.stat, lags=int(cfg.lags),
                kappa=int(cfg.kappa), deviation=0.0,
                value_codec=self.value_codec, stored_nbytes=0,
                payload_nbytes=0, meta_nbytes=0, meta_raw_nbytes=0,
                has_resid=bool(with_resid), blocks=[], streaming=True)
            if int(channels) > 1:
                # validate only — the v4 magic flips at the first
                # multivariate block write, so a crash between open and
                # the first block leaves the old footer fully readable
                self._check_mvar_writable()
                entry["channels"] = int(channels)
                entry["deviations"] = [0.0] * int(channels)
            self._series[sid] = entry
            self._bump_totals(series=1)
            sess = StreamSession(self, sid, cfg, dtype=entry["dtype"],
                                 with_resid=with_resid, entry=entry,
                                 block_len=block_len)
        self._streams[sid] = sess
        return sess

    # -- catalog ------------------------------------------------------------

    def series_ids(self) -> List[str]:
        return list(self._series)

    def series_meta(self, sid: str) -> dict:
        return self._series[sid]

    def __contains__(self, sid: str) -> bool:
        return sid in self._series

    # -- block access -------------------------------------------------------

    def _finish_body(self, blk: dict, raw: bytes) -> bytes:
        """Tier accounting + cold-tier unwrap of one fetched body.

        Catalog entries of cold blocks carry a ``"wrap"`` key naming the
        entropy codec their on-disk body is wrapped in (see
        ``store/maintenance.py``); the unwrap reproduces the original
        length-prefixed body — crc and all — so every downstream parse and
        answer is byte-identical across tiers."""
        t = self._tier_counts
        wrap = blk.get("wrap")
        if wrap is None:
            t["warm_hits"] += 1
            t["warm_bytes"] += len(raw)
            return raw
        t["cold_hits"] += 1
        t["cold_bytes"] += len(raw)
        if OBS.enabled:
            OBS.inc("store.tier.cold.hits")
            OBS.inc("store.tier.cold.bytes", len(raw))
        return _codec.entropy_unwrap(bytes(raw), wrap)

    def _read_body(self, blk: dict) -> bytes:
        mm = self._mmap()
        if mm is not None:
            off = blk["offset"]
            blen, = struct.unpack_from("<I", mm, off)
            if OBS.enabled:
                OBS.inc("store.read.mmap_bytes", 4 + blen)
                OBS.inc("store.read.blocks_fetched")
            return self._finish_body(blk, mm[off + 4:off + 4 + blen])
        self._f.seek(blk["offset"])
        blen, = struct.unpack("<I", self._f.read(4))
        if OBS.enabled:
            OBS.inc("store.read.pread_bytes", 4 + blen)
            OBS.inc("store.read.blocks_fetched")
        return self._finish_body(blk, self._f.read(blen))

    def _read_bodies(self, blks: List[dict]) -> List[bytes]:
        """One body per catalog entry; blocks that sit contiguously in the
        file are fetched with a single seek+read instead of one pread per
        block (multi-block windows of an uninterleaved series are one IO).
        With an mmap attached every body is a page-cache slice — no
        syscalls at all, so no coalescing is needed."""
        if self._mmap() is not None:
            return [self._read_body(b) for b in blks]
        out: List[bytes] = []
        i = 0
        while i < len(blks):
            j = i
            end = blks[j]["offset"] + 4 + blks[j]["nbytes"]
            while j + 1 < len(blks) and blks[j + 1]["offset"] == end:
                j += 1
                end = blks[j]["offset"] + 4 + blks[j]["nbytes"]
            self._f.seek(blks[i]["offset"])
            buf = self._f.read(end - blks[i]["offset"])
            if OBS.enabled:
                OBS.inc("store.read.coalesced_runs")
                OBS.inc("store.read.pread_bytes", len(buf))
                OBS.inc("store.read.blocks_fetched", j - i + 1)
            pos = 0
            for k in range(i, j + 1):
                blen, = struct.unpack_from("<I", buf, pos)
                out.append(self._finish_body(blks[k],
                                             buf[pos + 4:pos + 4 + blen]))
                pos += 4 + blen
            i = j + 1
        return out

    def channels(self, sid: str) -> int:
        """Number of value columns (1 for univariate series)."""
        return int(self._series[sid].get("channels", 1))

    def _parse(self, sid: str):
        """Body parser for this series' block layout (v4 multivariate
        blocks vs the univariate v2/v3 layout)."""
        return parse_mblock if self.channels(sid) > 1 else parse_block

    def block_meta(self, sid: str, bi: int) -> BlockMeta:
        """Header metadata of one block (no bitstream decode) — cached, so
        repeated pushdown queries never re-read interior blocks.  For a
        multivariate series this is an ``MBlockMeta``; project one column
        with ``.col(c)``."""
        key = (sid, bi)
        meta = self._metas.get(key)
        if meta is None:
            blk = self._series[sid]["blocks"][bi]
            meta, _, _ = self._parse(sid)(self._read_body(blk),
                                          with_payload=False)
            self._metas[key] = meta
        return meta

    def block_metas(self, sid: str) -> List[BlockMeta]:
        """Header-only metadata of every block of a series; uncached
        headers are fetched with coalesced preads."""
        blks = self._series[sid]["blocks"]
        parse = self._parse(sid)
        missing = [bi for bi in range(len(blks))
                   if (sid, bi) not in self._metas]
        if missing:
            bodies = self._read_bodies([blks[bi] for bi in missing])
            for bi, body in zip(missing, bodies):
                meta, _, _ = parse(body, with_payload=False)
                self._metas[(sid, bi)] = meta
        return [self._metas[(sid, bi)] for bi in range(len(blks))]

    def _blocks(self, sid: str, bis: List[int]) -> List[list]:
        """Decoded cache entries for several blocks of one series; misses
        are fetched with coalesced preads and decoded in file order."""
        entries = {}
        misses = []
        for bi in bis:
            e = self._cache.get((sid, bi))
            if e is None:
                misses.append(bi)
            else:
                entries[bi] = e
        if misses:
            blks = self._series[sid]["blocks"]
            parse = self._parse(sid)
            bodies = self._read_bodies([blks[bi] for bi in misses])
            for bi, body in zip(misses, bodies):
                meta, idx, vals = parse(body)
                pmeta = (meta.sxx.nbytes if hasattr(meta, "sxx")
                         else meta.agg.nbytes)
                e = [meta, idx, vals, None,
                     idx.nbytes + vals.nbytes + pmeta
                     + meta.head_vec.nbytes + meta.tail_vec.nbytes + 256]
                self._cache.put((sid, bi), e)
                self._metas[(sid, bi)] = meta
                entries[bi] = e
        return [entries[bi] for bi in bis]

    def _block(self, sid: str, bi: int):
        """Decoded block (meta, global kept indices, values) — cached."""
        e = self._blocks(sid, [bi])[0]
        return e[_E_META], e[_E_IDX], e[_E_VALS]

    def prefetch(self, sid: str, a: int = 0, b: int = None) -> List[int]:
        """Decode the blocks overlapping ``[a, b)`` into the hot-tier LRU
        (coalesced fetches, same as a window read would) without
        materializing the window; returns the warmed block indices."""
        entry = self._series[sid]
        if b is None:
            b = entry["n"]
        bis = self._overlapping(sid, int(a), int(b))
        self._blocks(sid, bis)
        return bis

    def _overlapping(self, sid: str, a: int, b: int):
        """Indices of blocks whose *owned* range intersects [a, b).  While a
        stream session is still appending, no block owns its right border —
        the final point arrives with the closing block."""
        entry = self._series[sid]
        streaming = bool(entry.get("streaming"))
        out = []
        for bi, blk in enumerate(entry["blocks"]):
            is_last = bi == len(entry["blocks"]) - 1 and not streaming
            o1 = blk["t1"] + 1 if is_last else blk["t1"]
            if blk["t0"] < b and o1 > a:
                out.append(bi)
        return out

    # -- reads --------------------------------------------------------------

    def read_kept(self, sid: str):
        """(indices, values) of the stored kept points over the readable
        range ``[0, n)`` — for a still-streaming series that excludes the
        last block's right border (it reappears as the next block's first
        point when the stream continues).  Multivariate values come back
        ``[k, C]`` (the shared index stream is one array either way)."""
        entry = self._series[sid]
        dtype = np.dtype(entry["dtype"])
        C = int(entry.get("channels", 1))
        nb = len(entry["blocks"])
        if nb == 0:      # streaming series before its first block commits
            return (np.empty(0, np.int64),
                    np.empty(0 if C == 1 else (0, C), dtype))
        idx_parts, val_parts = [], []
        streaming = bool(entry.get("streaming"))
        for bi, e in enumerate(self._blocks(sid, list(range(nb)))):
            idx, vals = e[_E_IDX], e[_E_VALS]
            if bi < nb - 1 or streaming:   # shared border belongs to next
                idx, vals = idx[:-1], vals[:-1]
            idx_parts.append(idx)
            val_parts.append(vals)
        return (np.concatenate(idx_parts),
                np.concatenate(val_parts).astype(dtype))

    def kept_mask(self, sid: str) -> np.ndarray:
        mask = np.zeros(self._series[sid]["n"], bool)
        mask[self.read_kept(sid)[0]] = True
        return mask

    def read_window(self, sid: str, a: int, b: int,
                    col: int = None) -> np.ndarray:
        """Reconstruction slice ``xr[a:b]``, decoding only the blocks whose
        range overlaps the window.  Bit-exact vs the full reconstruction.
        Per-block reconstructions are attached to the LRU entries, so a hot
        window skips pread, bitstream decode *and* interpolation.

        For a multivariate series the slice is ``[b-a, C]``; ``col``
        selects a single column (``[b-a]``).  All columns of a touched
        block are reconstructed and cached together — a per-column query
        loop pays the interpolation once."""
        entry = self._series[sid]
        n = entry["n"]
        C = int(entry.get("channels", 1))
        if col is not None and not (0 <= int(col) < C):
            raise ValueError(f"column {col} outside [0, {C}) for {sid!r}")
        a, b = max(int(a), 0), min(int(b), n)
        dtype = np.dtype(entry["dtype"])
        if b <= a:
            return np.empty((0,) if C == 1 or col is not None else (0, C),
                            dtype)
        out = np.empty((b - a,) if C == 1 else (b - a, C), dtype)
        bis = self._overlapping(sid, a, b)
        for bi, e in zip(bis, self._blocks(sid, bis)):
            meta, xr_b = e[_E_META], e[_E_XR]
            if xr_b is None:
                if C == 1:
                    xr_b = reconstruct_block(
                        e[_E_IDX] - meta.t0, e[_E_VALS], meta.span,
                        str(dtype), self.device)
                else:
                    xr_b = np.stack(
                        [reconstruct_block(
                            e[_E_IDX] - meta.t0,
                            np.ascontiguousarray(e[_E_VALS][:, c]),
                            meta.span, str(dtype), self.device)
                         for c in range(C)],
                        axis=1)
                e[_E_XR] = xr_b
                self._cache.grow((sid, bi), xr_b.nbytes)
            lo, hi = max(a, meta.o0), min(b, meta.o1)
            out[lo - a:hi - a] = xr_b[lo - meta.t0:hi - meta.t0]
        if col is not None and C > 1:
            return np.ascontiguousarray(out[:, col])
        return out

    def read_series(self, sid: str, col: int = None) -> np.ndarray:
        """Whole-series reconstruction (bit-exact vs ``CompressResult.xr``;
        ``[n, C]`` for multivariate series, ``col`` selects one column)."""
        return self.read_window(sid, 0, self._series[sid]["n"], col=col)

    # -- accounting ---------------------------------------------------------

    def cache_stats(self) -> dict:
        """Decoded-block LRU counters (hits/misses/evictions/bytes)."""
        return self._cache.stats()

    def tier_stats(self) -> dict:
        """Per-tier read counters.  ``hot`` is the decoded-block LRU (a hit
        never touches the file), ``warm`` counts plain body fetches from
        mmap/pread, ``cold`` counts entropy-wrapped body fetches (bytes are
        the wrapped on-disk sizes); ``dead_nbytes`` is the file space
        orphaned by compaction / tier rewrites (reclaimable by a copying
        rewrite of the store)."""
        c = self._cache
        t = self._tier_counts
        return dict(
            hot=dict(hits=c.hits, misses=c.misses, nbytes=c.nbytes,
                     pinned=len(c._pinned)),
            warm=dict(hits=t["warm_hits"], nbytes=t["warm_bytes"]),
            cold=dict(hits=t["cold_hits"], nbytes=t["cold_bytes"]),
            dead_nbytes=self._dead_nbytes)

    def ingest_totals(self) -> dict:
        """O(1) running ingest totals across every stored series.

        ``points``/``n_kept`` are channel-expanded (``n * C``) and
        ``raw_nbytes`` is 8 bytes/point, matching the per-series
        ``compression_stats`` conventions; still-streaming series count
        their committed (readable) prefix.  Maintained incrementally on
        every append/stream emit and rebuilt in one O(series) pass at
        open — this is what ``Dataset.stats()`` and
        ``TimeSeriesService.stats()`` serve instead of walking
        ``compression_stats`` per poll (pass ``deep=True`` there for
        the exhaustive walk)."""
        return dict(self._totals)

    def compression_stats(self, sid: str) -> dict:
        """Point-count CR vs byte-true CRs for one stored series.

        ``bytes_cr`` divides by the physical file bytes (codec payloads +
        block headers with their compacted ``[5, L]`` pushdown metadata);
        ``codec_cr`` divides by the codec payloads alone (the
        Table-2-comparable number).  ``meta_nbytes`` / ``meta_raw_nbytes``
        expose what the shuffle+delta coding saved on header metadata.
        """
        e = self._series[sid]
        C = int(e.get("channels", 1))
        raw_nbytes = 8 * e["n"] * C
        payload = e.get("payload_nbytes", e["stored_nbytes"])
        return dict(
            n=e["n"], n_kept=e["n_kept"], channels=C,
            point_cr=e["n"] / max(e["n_kept"], 1),
            stored_nbytes=e["stored_nbytes"],
            payload_nbytes=payload,
            meta_nbytes=e.get("meta_nbytes", 0),
            meta_raw_nbytes=e.get("meta_raw_nbytes", 0),
            bytes_cr=raw_nbytes / max(e["stored_nbytes"], 1),
            codec_cr=raw_nbytes / max(payload, 1),
            raw_nbytes=raw_nbytes)


class StreamSession:
    """Streaming append session for one series (see ``open_stream``).

    Feed it contiguous stream windows — ``append(start, x, kept)`` or
    ``append_window(w)`` with a ``core/streaming.WindowResult`` — and it
    writes a block the moment the incremental planner can prove the
    block's right border matches what ``plan_block_bounds`` would pick on
    the full kept set: a border ``t1`` (the first kept point
    ``>= t0 + block_len``) commits once some kept point ``>= t1 + L``
    has been seen, which rules the tail-merge clamp out.  ``close()``
    plans the remaining tail with the full rule and finalizes the catalog
    entry; the result is byte-identical to the one-shot path.

    Freshly written blocks get *per-block* cache invalidation (they are
    new keys — existing cached blocks of the series stay valid, unlike
    ``append_series``'s wholesale invalidation of a replaced series).

    State held: the kept points past the last committed border, the raw
    originals over the same span (residual metadata), and the contiguity
    cursor — O(block_len + window).  ``_stash()`` round-trips all of it
    (plus an opaque ``state_provider()`` client blob) through the footer
    JSON bit-exactly for ``resume``.
    """

    def __init__(self, store: CameoStore, sid: str, cfg, *, dtype: str,
                 with_resid: bool, entry: dict, stash: dict = None,
                 block_len: int = None):
        self._store = store
        self.sid = sid
        self.cfg = cfg
        self.dtype = np.dtype(dtype)
        self.with_resid = bool(with_resid)
        self._entry = entry
        self.channels = int(entry.get("channels", 1))
        # a stashed override wins over the argument: the session must keep
        # planning the same borders it was planning before the resume
        if stash is not None and stash.get("block_len") is not None:
            block_len = stash["block_len"]
        self._block_len_override = None if not block_len else int(block_len)
        self._block_len = max(
            int(self._block_len_override or store.block_len), int(cfg.lags))
        self._closed = False
        self.state_provider = None        # callable -> JSON-safe blob
        self.restored_client_state = None
        # pending value/original buffers are [k] univariate, [k, C] mvar
        vshape = (0,) if self.channels == 1 else (0, self.channels)
        # pending state: consolidated arrays + unconsolidated append parts
        # (appends go to the lists; concatenation is deferred until a block
        # border is actually provable, so tiny-chunk feeds stay O(1)
        # amortized instead of re-copying the pending buffers every push)
        self._idx_parts: List[np.ndarray] = []
        self._val_parts: List[np.ndarray] = []
        self._x_parts: List[np.ndarray] = []
        if stash is None:
            self._kept_idx = np.empty(0, np.int64)
            self._kept_vals = np.empty(vshape, self.dtype)
            self._x = np.empty(vshape, np.float64)
            self._x_off = 0          # absolute index of _x[0]
            self._next = None        # expected start of the next append
            self._bound = None       # last committed block border
            self._committed = 0      # kept points strictly inside coverage
            self._total_kept = 0     # unique kept points seen
        else:
            self._kept_idx = np.asarray(stash["kept_idx"], np.int64)
            self._kept_vals = np.asarray(
                stash["kept_vals"],
                np.float64).reshape(-1, *vshape[1:]).astype(self.dtype)
            self._x = np.asarray(stash["x"],
                                 np.float64).reshape(-1, *vshape[1:])
            self._x_off = int(stash["x_off"])
            self._next = None if stash["next"] is None else int(stash["next"])
            self._bound = (None if stash["bound"] is None
                           else int(stash["bound"]))
            self._committed = int(stash["committed"])
            self._total_kept = int(stash["total_kept"])
            self.restored_client_state = stash.get("client")
        self._first_kept = (int(self._kept_idx[0])
                            if self._kept_idx.shape[0] else None)
        self._last_kept = (int(self._kept_idx[-1])
                           if self._kept_idx.shape[0] else None)

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # finalize only on clean exit: an exception mid-feed must leave the
        # stream incomplete (and hence resumable), not truncate it into a
        # series that claims to be whole
        if exc[0] is None and not self._closed:
            self.close()

    def flush(self):
        """Make the ingested prefix durable (rewrites the store footer,
        embedding this session's resume state)."""
        self._store.flush()

    # -- ingest --------------------------------------------------------------

    def append_window(self, w) -> None:
        """Absorb one closed stream window (``core/streaming.WindowResult``
        or anything with ``.start``, ``.x``, ``.kept``)."""
        self.append(w.start, w.x, w.kept)

    def append_windows(self, wins) -> None:
        """Absorb a burst of closed stream windows (a batched-ingest drain)
        with one border scan for the whole burst: every window buffers
        first, then every provable block commits.  Bytes are identical to
        appending the windows one at a time — the committed borders depend
        only on the accumulated kept set, not on the call pattern."""
        for w in wins:
            self._absorb(w.start, w.x, w.kept)
        self._commit_ready()

    def append(self, start: int, x, kept) -> None:
        """Absorb the contiguous window ``x`` at absolute index ``start``
        with its kept mask; writes every block whose border is provable."""
        self._absorb(start, x, kept)
        self._commit_ready()

    def _absorb(self, start: int, x, kept) -> None:
        if self._closed:
            raise ValueError(f"stream session for {self.sid!r} is closed")
        x = np.asarray(x)
        kept = np.asarray(kept, bool)
        if self.channels == 1:
            if x.shape != kept.shape or x.ndim != 1:
                raise ValueError(f"window shapes disagree: x {x.shape} vs "
                                 f"kept {kept.shape}")
        elif (x.ndim != 2 or x.shape[1] != self.channels
                or kept.shape != x.shape[:1]):
            raise ValueError(
                f"multivariate window wants x [m, {self.channels}] and "
                f"kept [m]; got x {x.shape}, kept {kept.shape}")
        if self._next is not None and int(start) != self._next:
            raise ValueError(f"non-contiguous append: expected index "
                             f"{self._next}, got {start}")
        if self._next is None:
            self._x_off = int(start)
        self._next = int(start) + x.shape[0]
        idx = int(start) + np.flatnonzero(kept)
        if idx.shape[0]:
            self._idx_parts.append(idx)
            self._val_parts.append(x[kept].astype(self.dtype))
            if self._first_kept is None:
                self._first_kept = int(idx[0])
            self._last_kept = int(idx[-1])
            self._total_kept += int(idx.shape[0])
        if self.with_resid:
            self._x_parts.append(np.asarray(x, np.float64))

    def _consolidate(self) -> None:
        if self._idx_parts:
            self._kept_idx = np.concatenate(
                [self._kept_idx] + self._idx_parts)
            self._kept_vals = np.concatenate(
                [self._kept_vals] + self._val_parts)
            self._idx_parts, self._val_parts = [], []
        if self._x_parts:
            self._x = np.concatenate([self._x] + self._x_parts)
            self._x_parts = []

    def _commit_ready(self) -> None:
        L = int(self.cfg.lags)
        t0 = self._first_kept if self._bound is None else self._bound
        if (self._last_kept is None or t0 is None
                or self._last_kept < t0 + self._block_len + L):
            return        # no border provable yet; keep buffering parts
        self._consolidate()
        while True:
            kept = self._kept_idx
            if kept.shape[0] == 0:
                return
            t0 = int(kept[0]) if self._bound is None else self._bound
            j = int(np.searchsorted(kept, t0 + self._block_len, "left"))
            if j >= kept.shape[0]:
                return
            t1 = int(kept[j])
            if int(kept[-1]) < t1 + L:
                return        # tail-merge clamp not ruled out yet
            self._emit(j, t1, is_last=False)

    def _emit(self, j: int, t1: int, is_last: bool) -> None:
        kept, vals = self._kept_idx, self._kept_vals
        if not is_last:
            kept, vals = kept[:j + 1], vals[:j + 1]
        t0 = int(kept[0])
        o1 = t1 + 1 if is_last else t1
        cfg = self.cfg
        store = self._store
        if self.channels > 1:
            body, binfo = store._mvar_body(
                kept, vals, t0=t0, t1=t1, is_last=is_last,
                dtype=str(self.dtype), cfg=cfg,
                x64=self._x if self.with_resid else None,
                x_off=self._x_off)
        else:
            owned_xr = reconstruct_block(kept - t0, vals, t1 - t0 + 1,
                                         str(self.dtype),
                                         store.device)[:o1 - t0]
            resid = None
            if self.with_resid:
                resid = (self._x[t0 - self._x_off:o1 - self._x_off]
                         - owned_xr)
            body, binfo = build_block(
                kept, vals, t0=t0, t1=t1, is_last=is_last,
                owned_xr=owned_xr, L=cfg.lags, kappa=cfg.kappa,
                stat=cfg.stat, eps=cfg.eps, resid=resid,
                value_codec=store.value_codec, entropy=store.entropy,
                meta_version=store._block_meta_version)
        off = store._append_body(body)
        e = self._entry
        old_n, old_kept = e["n"], e["n_kept"]
        bi = len(e["blocks"])
        e["blocks"].append(dict(offset=off, nbytes=len(body), t0=t0, t1=t1))
        e["stored_nbytes"] += 4 + len(body)
        e["payload_nbytes"] += binfo["payload_nbytes"]
        e["meta_nbytes"] += binfo["meta_nbytes"]
        e["meta_raw_nbytes"] += binfo["meta_raw_nbytes"]
        # per-append invalidation: only the new block's (never-yet-cached)
        # key — previously decoded blocks of this series stay valid
        store._cache.drop((self.sid, bi))
        store._metas.pop((self.sid, bi), None)
        if is_last:
            self._committed = self._total_kept
            self._kept_idx = self._kept_idx[:0]
            self._kept_vals = self._kept_vals[:0]
            self._x = self._x[:0]
            e["n"] = t1 + 1
        else:
            self._committed += j
            self._kept_idx = self._kept_idx[j:]
            self._kept_vals = self._kept_vals[j:]
            if self.with_resid:
                self._x = self._x[t1 - self._x_off:]
            self._x_off = t1
            self._bound = t1
            e["n"] = t1
        e["n_kept"] = self._committed
        C = self.channels
        store._bump_totals(points=(e["n"] - old_n) * C,
                           n_kept=(e["n_kept"] - old_kept) * C,
                           stored=4 + len(body))

    # -- finalize ------------------------------------------------------------

    def close(self, deviation: float = 0.0, deviations=None) -> dict:
        """Write the tail blocks (full ``plan_block_bounds`` rule, the last
        one owning the stream's end point), finalize the catalog entry to
        the exact one-shot form, and return it.  ``deviation`` is recorded
        in the catalog (the serving layer passes the streaming compressor's
        exact measured global deviation); multivariate sessions also record
        the per-column ``deviations``."""
        if self._closed:
            raise ValueError(f"stream session for {self.sid!r} already "
                             "closed")
        if self._total_kept < 2:
            raise ValueError("a stored series needs at least 2 kept points")
        self._consolidate()
        # tail planning is the planner itself, not a re-implementation: the
        # pending kept set starts at the last committed border (or the first
        # kept point), and the greedy rule only ever looks forward, so
        # planning the suffix reproduces the whole-series plan's tail —
        # which is what keeps streamed files byte-identical to one-shot
        bounds = plan_block_bounds(self._kept_idx, self._block_len,
                                   int(self.cfg.lags))
        last = int(bounds[-1])
        for bi in range(len(bounds) - 1):
            t1 = int(bounds[bi + 1])
            j = int(np.searchsorted(self._kept_idx, t1, "left"))
            self._emit(j, t1, is_last=(bi == len(bounds) - 2))
        # the finalized blocks are durable before the catalog entry that
        # publishes them can be (CAMEO_FSYNC=0 keeps just the write order)
        _wal.maybe_fsync(self._store._f)
        e = self._entry
        e["n"] = last + 1
        e["n_kept"] = self._total_kept
        e["deviation"] = float(deviation)
        if self.channels > 1:
            e["deviations"] = [float(d) for d in (
                deviations if deviations is not None
                else [deviation] * self.channels)]
        e.pop("streaming", None)
        e.pop("stream_state", None)
        # canonical key order — the finalized entry (hence the final footer
        # bytes) must match append_series's one-shot form exactly
        keys = ("n", "n_kept", "dtype", "eps", "stat", "lags", "kappa",
                "deviation", "value_codec", "stored_nbytes",
                "payload_nbytes", "meta_nbytes", "meta_raw_nbytes",
                "has_resid")
        keys += (("channels", "deviations", "blocks") if self.channels > 1
                 else ("blocks",))
        final = {k: e[k] for k in keys}
        self._entry = final
        self._store._series[self.sid] = final
        self._store._streams.pop(self.sid, None)
        self._closed = True
        return final

    # -- resume support ------------------------------------------------------

    def _stash(self) -> dict:
        """JSON-safe session state for the footer (floats round-trip via
        repr, so the resume is bit-exact)."""
        self._consolidate()
        return dict(
            dtype=str(self.dtype), with_resid=self.with_resid,
            block_len=self._block_len_override,
            bound=self._bound, next=self._next, x_off=self._x_off,
            committed=self._committed, total_kept=self._total_kept,
            kept_idx=[int(i) for i in self._kept_idx],
            kept_vals=np.asarray(self._kept_vals, np.float64).tolist(),
            x=np.asarray(self._x, np.float64).tolist(),
            client=(self.state_provider() if self.state_provider is not None
                    else None))
