"""Write-ahead journal for crash-safe
:class:`~repro_torch.store.store.CameoStore` ingest.

The store file itself is append-mostly but *not* crash-safe on its own: the
footer catalog lives at the tail and is truncated away at the start of every
append run, so a writer that dies mid-run leaves a store with no catalog and
(possibly) a torn block at EOF.  The journal closes that gap.  It is a
sidecar file (``<store>.wal``) that records

1. a **checkpoint** — an image of the last durably published footer (or the
   bare header when no footer has been written yet), plus the layout
   parameters needed to reconstruct an empty store, and
2. the sequence of **acked pushes** since that checkpoint, as raw float64
   payloads.

Recovery rolls the store file back to the checkpointed footer (restoring the
footer bytes that the append run truncated) and then *replays* the journaled
pushes through the deterministic compression pipeline.  Because compression
is deterministic and chunking-invariant, replay regenerates byte-identical
blocks — the journal never needs to record compressed output, only the raw
points the caller was told were accepted.

On-disk format
--------------
::

    b"CAMEOWAL\\x01"                        # 9-byte header
    [u32 payload_len][u32 crc32(payload)][payload]   # repeated records

Record payloads start with a one-byte type tag:

``type 1 — CHECKPOINT`` (always the first record of a journal generation)
    ``u8 store_version | u64 footer_offset | u32 meta_len | meta_json |
    u32 footer_len | footer_bytes``.  ``footer_bytes`` is the verbatim
    zlib-compressed footer blob (``b""`` when the store has never written
    one); ``meta_json`` carries ``block_len`` / ``value_codec`` /
    ``entropy`` so an empty store can be re-created with the right layout.

``type 2 — PUSH``
    ``u8 pad | u16 sid_len | sid_utf8 | u64 start | u32 m | u16 channels |
    m*(channels or 1) float64 LE values``.  ``channels == 0`` marks a 1-D
    payload.  ``start`` is the absolute point index of the first value
    (``StreamingCompressor.n_seen`` at ack time), which makes replay
    idempotent: records at or below the resumed compressor's watermark are
    skipped, and a gap raises instead of silently corrupting.

A torn tail — short record header, short payload, or checksum mismatch — is
detected by the scan and the journal is treated as ending at the last intact
record (the crash happened mid-append; that record was never acked as
journaled).  A checkpoint record anywhere but position 0 also stops the
scan: generations are whole-file rewrites, so a mid-file checkpoint can only
be corruption.

Group commit
------------
``append_push`` writes through to the OS immediately (``flush``), so an
acked push survives a *process* crash as soon as the call returns.  The
more expensive ``fsync`` — the power-loss barrier — is amortized: the
journal fsyncs when either ``group_bytes`` of un-synced payload or
``group_ms`` of wall-clock time has accumulated since the last barrier.
``group_ms=0`` degenerates to fsync-per-push.  Checkpoints are atomic:
the new generation is written to ``<store>.wal.tmp``, fsynced, and
``os.replace``d over the live journal, so a crash during checkpointing
leaves either the old or the new journal, never a torn hybrid.

``CAMEO_FSYNC=0`` disables every ``os.fsync`` in the package (tests,
throwaway runs); the journal degrades to process-crash safety only.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from ..obs import OBS

MAGIC = b"CAMEOWAL\x01"
_REC = struct.Struct("<II")          # payload length, crc32(payload)
_CKPT_HEAD = struct.Struct("<BBQ")   # type, store_version, footer_offset
_PUSH_HEAD = struct.Struct("<BBH")   # type, pad, sid_len
_PUSH_BODY = struct.Struct("<QIH")   # start, m, channels (0 == 1-D)

REC_CHECKPOINT = 1
REC_PUSH = 2

# Cap on a single record payload: a push of ~128 Mi float64 values.  Anything
# larger in a length prefix is treated as a torn/corrupt record by the scan.
_MAX_PAYLOAD = 1 << 30

DEFAULT_GROUP_MS = 5.0
DEFAULT_GROUP_BYTES = 256 << 10


def fsync_enabled() -> bool:
    """``True`` unless ``CAMEO_FSYNC=0`` opts out of durability barriers."""
    return os.environ.get("CAMEO_FSYNC", "1") != "0"


def maybe_fsync(f) -> None:
    """Flush ``f`` to the OS and — unless ``CAMEO_FSYNC=0`` — to stable
    storage.  The flush always happens; only the fsync is gated, so tests
    that disable barriers still exercise the same write ordering."""
    f.flush()
    if fsync_enabled():
        os.fsync(f.fileno())


class Checkpoint(NamedTuple):
    """Image of the store's last published state.

    ``footer == b""`` means the store had no footer yet (fresh ``mode="w"``
    run): recovery rolls the file back to the bare header and rebuilds the
    layout from ``meta``.
    """

    store_version: int
    footer_offset: int
    meta: dict              # block_len / value_codec / entropy
    footer: bytes           # verbatim zlib footer blob, b"" if none


class PushRecord(NamedTuple):
    """One acked push: ``x`` is float64 ``[m]`` or ``[m, C]``, ``start`` the
    absolute index of ``x[0]`` in the stream."""

    sid: str
    start: int
    x: np.ndarray


class WalScan(NamedTuple):
    """Result of :func:`scan`: the generation's checkpoint, the intact push
    records after it, and whether a torn tail was dropped."""

    checkpoint: Optional[Checkpoint]
    pushes: List[PushRecord]
    torn: bool


def _encode_checkpoint(ckpt: Checkpoint) -> bytes:
    meta = json.dumps(ckpt.meta, sort_keys=True).encode("utf-8")
    return b"".join([
        _CKPT_HEAD.pack(REC_CHECKPOINT, ckpt.store_version,
                        ckpt.footer_offset),
        struct.pack("<I", len(meta)), meta,
        struct.pack("<I", len(ckpt.footer)), ckpt.footer,
    ])


def _decode_checkpoint(payload: bytes) -> Checkpoint:
    rtype, version, off = _CKPT_HEAD.unpack_from(payload, 0)
    pos = _CKPT_HEAD.size
    (mlen,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    meta = json.loads(payload[pos:pos + mlen].decode("utf-8"))
    pos += mlen
    (flen,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    footer = payload[pos:pos + flen]
    if len(footer) != flen:
        raise ValueError("checkpoint record truncated")
    return Checkpoint(version, off, meta, footer)


def _encode_push(rec: PushRecord) -> bytes:
    x = np.ascontiguousarray(rec.x, dtype=np.float64)
    if x.ndim == 1:
        m, channels = x.shape[0], 0
    elif x.ndim == 2:
        m, channels = int(x.shape[0]), int(x.shape[1])
    else:
        raise ValueError(f"push payload must be 1-D or 2-D, got {x.ndim}-D")
    sid = rec.sid.encode("utf-8")
    if len(sid) > 0xFFFF:
        raise ValueError("series id too long to journal")
    return b"".join([
        _PUSH_HEAD.pack(REC_PUSH, 0, len(sid)), sid,
        _PUSH_BODY.pack(int(rec.start), m, channels),
        x.astype("<f8", copy=False).tobytes(),
    ])


def _decode_push(payload: bytes) -> PushRecord:
    rtype, _pad, sid_len = _PUSH_HEAD.unpack_from(payload, 0)
    pos = _PUSH_HEAD.size
    sid = payload[pos:pos + sid_len].decode("utf-8")
    pos += sid_len
    start, m, channels = _PUSH_BODY.unpack_from(payload, pos)
    pos += _PUSH_BODY.size
    count = m * (channels if channels else 1)
    data = np.frombuffer(payload, dtype="<f8", count=count, offset=pos)
    if data.shape[0] != count:
        raise ValueError("push record truncated")
    x = data.astype(np.float64)
    if channels:
        x = x.reshape(m, channels)
    return PushRecord(sid, int(start), x)


def _iter_records(blob: bytes):
    """Yield intact ``(payload, end_offset)`` pairs from a journal image,
    stopping (not raising) at the first torn or corrupt record."""
    pos = len(MAGIC)
    total = len(blob)
    while pos + _REC.size <= total:
        plen, crc = _REC.unpack_from(blob, pos)
        body_at = pos + _REC.size
        if plen > _MAX_PAYLOAD or body_at + plen > total:
            return                    # torn length prefix or short payload
        payload = blob[body_at:body_at + plen]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return                    # torn or bit-flipped payload
        pos = body_at + plen
        yield payload, pos


def scan(path: str) -> Optional[WalScan]:
    """Read a journal file tolerantly.

    Returns ``None`` when the file is missing, empty, or does not start
    with the journal magic (nothing recoverable).  Otherwise returns the
    checkpoint plus every intact push record, with ``torn=True`` when a
    trailing partial record was discarded.
    """
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return None
    if len(blob) < len(MAGIC) or blob[:len(MAGIC)] != MAGIC:
        return None
    ckpt: Optional[Checkpoint] = None
    pushes: List[PushRecord] = []
    end = len(MAGIC)
    for payload, pos in _iter_records(blob):
        if not payload:
            break
        rtype = payload[0]
        if rtype == REC_CHECKPOINT:
            if ckpt is not None:
                break                 # generations never embed checkpoints
            try:
                ckpt = _decode_checkpoint(payload)
            except Exception:
                break
        elif rtype == REC_PUSH:
            if ckpt is None:
                break                 # pushes before a checkpoint: corrupt
            try:
                pushes.append(_decode_push(payload))
            except Exception:
                break
        else:
            break                     # unknown record type: stop cleanly
        end = pos
    return WalScan(ckpt, pushes, torn=end < len(blob))


class WriteAheadLog:
    """Length-prefixed, checksummed journal with synchronous group commit.

    One instance belongs to exactly one writable :class:`CameoStore`; the
    store owns the lifecycle (``start`` at open, ``checkpoint`` after every
    footer publish, ``close`` — optionally removing the file — at store
    close)."""

    def __init__(self, path: str, f, *, group_ms: float, group_bytes: int):
        self.path = path
        self._f = f
        self.group_ms = float(group_ms)
        self.group_bytes = int(group_bytes)
        self._unsynced_bytes = 0
        self._unsynced_records = 0
        self._window_start: Optional[float] = None

    # -- lifecycle -----------------------------------------------------

    @classmethod
    def start(cls, path: str, checkpoint: Checkpoint,
              carry: Sequence[PushRecord] = (), *,
              group_ms: float = DEFAULT_GROUP_MS,
              group_bytes: int = DEFAULT_GROUP_BYTES) -> "WriteAheadLog":
        """Open a fresh journal generation at ``path``.

        The generation is built in ``path + ".tmp"`` (header, checkpoint,
        then ``carry`` — pushes from the previous generation that are still
        un-replayed), fsynced, and atomically published with
        ``os.replace``.  A crash at any point leaves either the previous
        journal or the complete new one."""
        tmp = path + ".tmp"
        f = open(tmp, "wb")
        try:
            f.write(MAGIC)
            for payload in [_encode_checkpoint(checkpoint)] + [
                    _encode_push(r) for r in carry]:
                f.write(_REC.pack(len(payload), zlib.crc32(payload)
                                  & 0xFFFFFFFF))
                f.write(payload)
            maybe_fsync(f)
        except BaseException:
            f.close()
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        f.close()
        os.replace(tmp, path)
        if fsync_enabled():
            # the rename itself must be durable before the store may
            # truncate state the journal now owns
            dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                          os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        out = open(path, "ab")
        if OBS.enabled:
            OBS.inc("wal.checkpoints")
        return cls(path, out, group_ms=group_ms, group_bytes=group_bytes)

    def checkpoint(self, checkpoint: Checkpoint,
                   carry: Sequence[PushRecord] = ()) -> None:
        """Truncate the journal to a new generation rooted at
        ``checkpoint``.  ``carry`` keeps acked pushes that the checkpointed
        footer does *not* already cover (streams that were journaled but
        never resumed this run)."""
        self._f.close()
        fresh = WriteAheadLog.start(self.path, checkpoint, carry,
                                    group_ms=self.group_ms,
                                    group_bytes=self.group_bytes)
        self._f = fresh._f
        self._unsynced_bytes = 0
        self._unsynced_records = 0
        self._window_start = None

    def close(self, remove: bool = False) -> None:
        """Sync and close the journal; ``remove=True`` deletes the file
        (used on clean store close, when the footer supersedes it)."""
        if self._f.closed:
            return
        self.sync()
        self._f.close()
        if remove:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    # -- appends -------------------------------------------------------

    def append_push(self, rec: PushRecord) -> None:
        """Journal one acked push.  Returns once the record is handed to
        the OS (process-crash safe); the power-loss barrier is amortized
        by the group-commit policy."""
        payload = _encode_push(rec)
        self._f.write(_REC.pack(len(payload),
                                zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self._f.flush()
        nbytes = _REC.size + len(payload)
        self._unsynced_bytes += nbytes
        self._unsynced_records += 1
        if self._window_start is None:
            self._window_start = time.perf_counter()
        if OBS.enabled:
            OBS.inc("wal.records")
            OBS.inc("wal.append_bytes", nbytes)
        elapsed_ms = (time.perf_counter() - self._window_start) * 1e3
        if (self._unsynced_bytes >= self.group_bytes
                or elapsed_ms >= self.group_ms):
            self.sync()

    def sync(self) -> None:
        """Group-commit barrier: one fsync covering every append since the
        previous barrier."""
        if not self._unsynced_records:
            return
        batch = self._unsynced_records
        t0 = time.perf_counter()
        maybe_fsync(self._f)
        if OBS.enabled:
            OBS.inc("wal.group_commits")
            OBS.observe("wal.fsync_seconds", time.perf_counter() - t0)
            OBS.observe("wal.group_batch_records", float(batch))
        self._unsynced_bytes = 0
        self._unsynced_records = 0
        self._window_start = None
