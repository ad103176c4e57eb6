"""Background maintenance rewrites over a writable :class:`CameoStore`.

Three rewrites, all sharing one atomicity story: new bytes are appended
past the last published footer, the in-memory catalog is repointed, and
``store.flush()`` publishes the new footer with the two-phase fsync
protocol.  **Nothing is ever overwritten in place** — the superseded
block bodies stay intact below the old footer offset, so a crash at any
point rolls back to the previous footer via the WAL checkpoint and the
store reads exactly as before the rewrite started.  The orphaned bytes
are accounted in ``store.tier_stats()['dead_nbytes']``.

``compact_series``
    Merge runs of adjacent small blocks (the low-latency seal output of
    server stream sessions, ``open_stream(block_len=...)``) into
    full-size blocks.  Block borders are kept points and owned ranges
    partition the series, so the merge is a pure re-blocking: kept
    points and window decodes are **bit-exact** before and after, and
    the stored Plato residual moments of the merged block are the sums
    (max for ``emax``) of the parts' moments — no access to the original
    series is needed.  Pushdown aggregates keep their deterministic
    bounds; their values are re-associated sums, so they agree to
    floating-point re-association (~1 ulp per merge), not bitwise.

``rewrite_cold`` / ``promote_warm``
    Demote block bodies to the cold tier by entropy-wrapping them
    (``codec.entropy_wrap``; a wrap that does not shrink is skipped), or
    promote them back to plain warm bodies.  The catalog block dict of a
    cold block carries ``"wrap": <codec>``; the read path unwraps on
    fetch (``CameoStore._finish_body``), reproducing the original body —
    crc included — so every parse, decode and query answer is
    byte-identical across tiers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs import OBS
from repro_torch.store import codec as _codec
from repro_torch.store.blocks import (
    _HDR,
    build_block,
    parse_block,
    reconstruct_block,
)


def _check_rewritable(store, sid: str) -> dict:
    if not store._writable:
        raise IOError("store opened read-only")
    entry = store._series.get(sid)
    if entry is None:
        raise KeyError(f"series {sid!r} not in store")
    if entry.get("streaming"):
        raise ValueError(f"series {sid!r} is still streaming — close the "
                         "session before maintenance rewrites")
    return entry


def _finish(store, sid: str) -> None:
    """Publish a rewrite: drop stale decoded state, then flush the footer
    (the atomic commit point — see module docstring)."""
    store._cache.invalidate(sid)
    for key in [k for k in store._metas if k[0] == sid]:
        del store._metas[key]
    store.flush()


def compact_series(store, sid: str, *, target_len: int = None) -> dict:
    """Merge runs of adjacent small blocks of one finished univariate
    series into blocks of at least ``target_len`` span (default: the
    store-wide ``block_len``).  Returns a report dict; a series with
    nothing to merge is a no-op (no bytes written, no footer flush).
    """
    entry = _check_rewritable(store, sid)
    if int(entry.get("channels", 1)) > 1:
        raise ValueError(f"series {sid!r}: compaction of multivariate "
                         "series is not supported yet")
    if store._block_meta_version < 3:
        raise ValueError("compaction needs a v3+ store")
    blocks = entry["blocks"]
    target = int(target_len or store.block_len)

    # greedy run plan: extend a run while its covered span is still short
    # of the target; only runs of >= 2 blocks are rewritten
    runs = []
    i = 0
    while i < len(blocks):
        j = i
        while (j + 1 < len(blocks)
               and blocks[j]["t1"] - blocks[i]["t0"] + 1 < target):
            j += 1
        if j > i:
            runs.append((i, j))
        i = j + 1
    report = dict(sid=sid, runs=len(runs), blocks_before=len(blocks),
                  blocks_after=len(blocks), stored_before=entry[
                      "stored_nbytes"], stored_after=entry["stored_nbytes"],
                  dead_nbytes=0)
    if not runs:
        return report

    dtype = np.dtype(entry["dtype"])
    L = int(entry["lags"])
    has_resid = bool(entry.get("has_resid"))
    old_stored = entry["stored_nbytes"]

    new_blocks = []
    stored = payload = meta_n = meta_raw = 0
    dead = 0
    run_iter = iter(runs + [(len(blocks), len(blocks))])
    run_i, run_j = next(run_iter)
    bi = 0
    while bi < len(blocks):
        if bi < run_i:
            # kept verbatim: recompute its byte accounting from the header
            blk = blocks[bi]
            body = store._read_body(blk)
            meta, _, _ = parse_block(body, with_payload=False)
            stored += 4 + blk["nbytes"]
            payload += meta.payload_nbytes
            meta_n += len(body) - _HDR.size - meta.payload_nbytes - 4
            meta_raw += 8 * (L + meta.head_vec.shape[0]
                             + meta.tail_vec.shape[0])
            new_blocks.append(blk)
            bi += 1
            continue
        # merge blocks [run_i, run_j]: decode every part, concatenate the
        # kept points (each shared border appears as part k's last point
        # and part k+1's first — drop the duplicate), sum the moments
        part_blks = blocks[run_i:run_j + 1]
        bodies = store._read_bodies(part_blks)
        idx_parts, val_parts = [], []
        r1 = r2 = rx = 0.0
        emax = 0.0
        for k, body in enumerate(bodies):
            meta, idx, vals = parse_block(body)
            r1 += meta.r1
            r2 += meta.r2
            rx += meta.rx
            emax = max(emax, meta.emax)
            if k < len(bodies) - 1:
                idx, vals = idx[:-1], vals[:-1]
            idx_parts.append(idx)
            val_parts.append(vals)
        kept_idx = np.concatenate(idx_parts)
        kept_vals = np.ascontiguousarray(
            np.concatenate(val_parts).astype(dtype))
        t0 = int(part_blks[0]["t0"])
        t1 = int(part_blks[-1]["t1"])
        is_last = run_j == len(blocks) - 1
        o1 = t1 + 1 if is_last else t1
        owned_xr = reconstruct_block(kept_idx - t0, kept_vals,
                                     t1 - t0 + 1, str(dtype),
                                     store.device)[:o1 - t0]
        body, binfo = build_block(
            kept_idx, kept_vals, t0=t0, t1=t1, is_last=is_last,
            owned_xr=owned_xr, L=L, kappa=int(entry["kappa"]),
            stat=entry["stat"], eps=float(entry["eps"]),
            resid_moments=(r1, r2, rx, emax) if has_resid else None,
            value_codec=store.value_codec, entropy=store.entropy,
            meta_version=3)
        off = store._append_body(body)
        dead += sum(4 + b["nbytes"] for b in part_blks)
        stored += 4 + len(body)
        payload += binfo["payload_nbytes"]
        meta_n += binfo["meta_nbytes"]
        meta_raw += binfo["meta_raw_nbytes"]
        new_blocks.append(dict(offset=off, nbytes=len(body), t0=t0, t1=t1))
        bi = run_j + 1
        run_i, run_j = next(run_iter)

    entry["blocks"] = new_blocks
    entry["stored_nbytes"] = stored
    entry["payload_nbytes"] = payload
    entry["meta_nbytes"] = meta_n
    entry["meta_raw_nbytes"] = meta_raw
    store._dead_nbytes += dead
    store._bump_totals(stored=stored - old_stored)
    if OBS.enabled:
        OBS.inc("store.compaction.runs", len(runs))
        OBS.inc("store.compaction.blocks_merged",
                len(blocks) - len(new_blocks) + len(runs))
        OBS.inc("store.compaction.dead_bytes", dead)
    _finish(store, sid)
    report.update(blocks_after=len(new_blocks), stored_after=stored,
                  dead_nbytes=dead)
    return report


def rewrite_cold(store, sid: str, *, codec: str = "auto") -> dict:
    """Demote one series' block bodies to the cold tier: each plain body
    is entropy-wrapped and appended; the catalog block dict gains a
    ``"wrap"`` key.  Bodies the wrap cannot shrink stay warm.  Works for
    univariate and multivariate series (the body is opaque bytes here).
    """
    entry = _check_rewritable(store, sid)
    blocks = entry["blocks"]
    rewritten = skipped = 0
    dead = 0
    delta = 0
    for bi, blk in enumerate(blocks):
        if blk.get("wrap"):
            continue
        body = store._read_body(blk)
        wrapped, used = _codec.entropy_wrap(body, codec)
        if used == "none":
            skipped += 1
            continue
        off = store._append_body(wrapped)
        dead += 4 + blk["nbytes"]
        delta += len(wrapped) - blk["nbytes"]
        blocks[bi] = dict(offset=off, nbytes=len(wrapped),
                          t0=blk["t0"], t1=blk["t1"], wrap=used)
        rewritten += 1
    if rewritten:
        entry["stored_nbytes"] += delta
        store._dead_nbytes += dead
        store._bump_totals(stored=delta)
        _finish(store, sid)
    return dict(sid=sid, rewritten=rewritten, skipped=skipped,
                saved_nbytes=-delta, dead_nbytes=dead)


def promote_warm(store, sid: str) -> dict:
    """Promote one series back out of the cold tier: every wrapped body
    is unwrapped and re-appended as a plain warm body (the exact bytes
    the block was originally written with)."""
    entry = _check_rewritable(store, sid)
    blocks = entry["blocks"]
    rewritten = 0
    dead = 0
    delta = 0
    for bi, blk in enumerate(blocks):
        if not blk.get("wrap"):
            continue
        body = store._read_body(blk)   # _finish_body already unwrapped it
        off = store._append_body(body)
        dead += 4 + blk["nbytes"]
        delta += len(body) - blk["nbytes"]
        blocks[bi] = dict(offset=off, nbytes=len(body),
                          t0=blk["t0"], t1=blk["t1"])
        rewritten += 1
    if rewritten:
        entry["stored_nbytes"] += delta
        store._dead_nbytes += dead
        store._bump_totals(stored=delta)
        _finish(store, sid)
    return dict(sid=sid, rewritten=rewritten, dead_nbytes=dead)
