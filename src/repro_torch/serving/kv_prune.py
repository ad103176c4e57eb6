"""CAMEO-style KV-cache pruning (port of ``repro.serving.kv_prune``).

A KV cache is a time series of per-position keys; its per-position key-norm
sequence summarizes what attention reads.  Cache positions are ranked with
CAMEO itself (Def. 3, compression-centric: keep n/keep_ratio points that
best preserve the key-norm ACF) and the cache is compacted to the kept
slots.

The reference runs ``jax.vmap(compress_rounds)`` over the rows; the port
runs ``compress_batch`` over them on the cache's device (the CUDA kernels
on the card, their plain versions on the CPU), each lane bit-equal to its
solo run.  The host's drop and top-up are the reference's numpy, on the
same float32 values, so ties break the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cameo import CameoConfig, compress_batch
from repro_torch.kernels import ref
from repro_torch.models.attention import KVCache


def importance_series(cache: KVCache) -> torch.Tensor:
    """Per-position signal: mean key L2 norm across KV heads.  [B, S]
    float32, ``sqrt(mean(sum(k*k, -1), -1))`` summed in XLA's row-reduce
    order, divided once and rooted correctly rounded, so the card's series
    equals the CPU's and the reference's bit for bit."""
    k = cache.k.float()
    if cache.k_scale.dim() == 4:     # int8 cache
        k = k * cache.k_scale
    sq = ref.row_sum_xla(k * k)                       # [B, S, K]
    return ref.sqrt_rn(ref.div_exact(ref.row_sum_xla(sq), k.shape[-2]))


def selection_config(S: int, keep: int, lags: int = 16) -> CameoConfig:
    """The reference's CAMEO configuration for keeping ``keep`` of ``S``
    positions (``kv_prune.py:39-42``)."""
    cr = max(S / keep, 1.0 + 1e-6)
    return CameoConfig(lags=min(lags, S // 4), target_cr=float(cr),
                       mode="rounds", dtype="float32", max_rounds=64)


def select_from_series(sig: torch.Tensor, keep: int,
                       lags: int = 16) -> np.ndarray:
    """Kept slot indices [B, keep] (sorted) of the series ``sig [B, S]``:
    one ``compress_batch`` on ``sig``'s device, then the reference's host
    drop (lowest-importance interior picks) or top-up (highest-importance
    unkept positions)."""
    B, S = sig.shape
    res = compress_batch(sig, selection_config(S, keep, lags),
                         device=sig.device)
    kept = res.kept.cpu().numpy()                   # [B, S] bool
    sig_np = sig.cpu().numpy()
    idx = np.zeros((B, keep), np.int32)
    for b in range(B):
        sel = np.nonzero(kept[b])[0]
        if len(sel) >= keep:
            # drop lowest-importance interior picks down to `keep`
            order = np.argsort(sig_np[b][sel])
            drop = len(sel) - keep
            interior = order[(sel[order] != 0) & (sel[order] != S - 1)]
            sel = np.sort(np.setdiff1d(sel, sel[interior[:drop]]))
        else:
            # top-up with the highest-importance unkept positions
            unsel = np.setdiff1d(np.arange(S), sel)
            extra = unsel[np.argsort(-sig_np[b][unsel])][: keep - len(sel)]
            sel = np.sort(np.concatenate([sel, extra]))
        idx[b] = sel[:keep]
    return idx


def select_positions(cache: KVCache, keep: int, lags: int = 16):
    """CAMEO Def.-3 selection on the key-norm series.  Returns kept slot
    indices [B, keep] (sorted by position) on the cache's device."""
    idx = select_from_series(importance_series(cache), keep, lags)
    return torch.from_numpy(idx).to(cache.k.device)


def compact_cache(cache: KVCache, idx: torch.Tensor) -> KVCache:
    """Gather the kept slots into a cache of size keep (per layer leaf)."""
    B = idx.shape[0]
    bidx = torch.arange(B, device=idx.device)[:, None]
    idx = idx.long()

    def take(a):
        if a.dim() >= 2 and a.shape[0] == B and \
                a.shape[1] == cache.pos_ids.shape[1]:
            return a[bidx, idx]
        return a

    return KVCache(*(take(a) for a in cache))


def prune_tree(caches, keep: int, lags: int = 16):
    """Apply selection+compaction to every attention KVCache in a cache tree,
    one selection per layer.  A stacked block cache ``[n_blocks, B, ...]``
    folds its block axis into the lanes: all its layers' rows go through
    one ``compress_batch``."""
    def visit(node):
        if isinstance(node, KVCache):
            idx = select_positions(node, keep, lags)
            return compact_cache(node, idx)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return node

    def visit_stacked(node):
        if isinstance(node, KVCache) and node.pos_ids.dim() == 3:
            L, B, S = node.pos_ids.shape
            flat = KVCache(*[a.reshape((L * B,) + a.shape[2:])
                             if a.dim() >= 3 else a for a in node])
            idx = select_positions(flat, keep, lags)
            out = compact_cache(flat, idx)
            return KVCache(*[a.reshape((L, B) + a.shape[1:])
                             if a.dim() >= 2 and a.shape[0] == L * B else a
                             for a in out])
        if isinstance(node, KVCache):
            return visit(node)
        if isinstance(node, dict):
            return {k: visit_stacked(v) for k, v in node.items()}
        return node

    return visit_stacked(caches)
