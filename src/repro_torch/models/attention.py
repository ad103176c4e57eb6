"""Grouped-query attention (port of ``repro.models.attention``):
training/prefill (full or chunked flash-style) and single-token decode
against a (possibly windowed ring) KV cache.

The reference's einsums and float32 softmax statistics, written out (no
``scaled_dot_product_attention``).  One device: the reference's sharding
constraints are dropped.  The decode step writes the new entry into the
cache's tensors in place (the reference returns new arrays), and returns
the cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.models.layers import (apply_mrope, apply_rope, rmsnorm,
                                       rmsnorm_defs)
from repro_torch.models.params import ParamDef, TensorSpec

# Finite on purpose: in ``_sdpa_chunked`` a kv chunk that is wholly masked
# gives exp(s - m) = 1 until a real score arrives, and then
# corr = exp(-1e30 - m) zeroes what it added.  -inf would give NaNs.
NEG_INF = -1e30


def attention_defs(d: int, n_heads: int, n_kv: int, head_dim: int,
                   qk_norm: bool = False, qkv_bias: bool = False):
    defs = {
        "q": ParamDef((d, n_heads, head_dim), ("fsdp", "tp", None)),
        "k": ParamDef((d, n_kv, head_dim), ("fsdp", "kv_tp", None)),
        "v": ParamDef((d, n_kv, head_dim), ("fsdp", "kv_tp", None)),
        "o": ParamDef((n_heads, head_dim, d), ("tp", None, "fsdp")),
    }
    if qkv_bias:
        defs["q_bias"] = ParamDef((n_heads, head_dim), ("tp", None), init="zeros")
        defs["k_bias"] = ParamDef((n_kv, head_dim), ("kv_tp", None), init="zeros")
        defs["v_bias"] = ParamDef((n_kv, head_dim), ("kv_tp", None), init="zeros")
    if qk_norm:
        defs["q_norm"] = rmsnorm_defs(head_dim)
        defs["k_norm"] = rmsnorm_defs(head_dim)
    return defs


def _project_qkv(p, x: torch.Tensor, spec):
    q = torch.einsum("bsd,dhk->bshk", x, p["q"])
    k = torch.einsum("bsd,dhk->bshk", x, p["k"])
    v = torch.einsum("bsd,dhk->bshk", x, p["v"])
    if "q_bias" in p:
        q = q + p["q_bias"]
        k = k + p["k_bias"]
        v = v + p["v_bias"]
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


def _rope_qk(q, k, positions, spec):
    if spec.pos == "rope":
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    elif spec.pos == "mrope":
        # positions: [3, B, S]
        q = apply_mrope(q, positions, spec.mrope_sections, spec.rope_theta)
        k = apply_mrope(k, positions, spec.mrope_sections, spec.rope_theta)
    return q, k


def _mask(q_pos, k_pos, window: Optional[int]):
    """causal (+ sliding window) mask: [..., S_q, S_k] boolean (True=keep)."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return ok


def _sdpa(q, k, v, mask, scale: float):
    """q [B,Sq,H,dh], k/v [B,Sk,K,dh], mask [B,Sq,Sk] -> [B,Sq,H,dh] f32."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, Sq, H, dh)


def _sdpa_chunked(q, k, v, q_pos, k_pos, window, scale: float,
                  q_chunk: int, kv_chunk: int):
    """Flash-style online-softmax attention, O(S) memory: each q chunk walks
    every kv chunk in order (the reference's ``lax.map`` over ``lax.scan``).
    Positions are ``[B, S]``; ``S`` must be a multiple of both chunks."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"chunked attention needs S ({S}) divisible by the "
                         f"chunks ({q_chunk}, {kv_chunk})")
    nq, nk = S // q_chunk, S // kv_chunk
    qg = q.reshape(B, nq, q_chunk, K, G, dh)
    qp = q_pos.reshape(B, nq, q_chunk)
    kc = k.reshape(B, nk, kv_chunk, K, dh)
    vc = v.reshape(B, nk, kv_chunk, K, dh)
    kp = k_pos.reshape(B, nk, kv_chunk)
    outs = []
    for i in range(nq):
        qi, qpos = qg[:, i].float(), qp[:, i]
        m = torch.full((B, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, K, G, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, K, G, q_chunk, dh), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            msk = _mask(qpos, kp[:, j], window)                 # [B,qc,kc]
            s = torch.einsum("bqkgd,btkd->bkgqt", qi, kc[:, j].float()) * scale
            s = torch.where(msk[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            pj = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(pj, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", pj, vc[:, j].float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)        # [B,K,G,qc,dh]
        outs.append(out.permute(0, 3, 1, 2, 4))                 # [B,qc,K,G,dh]
    return torch.cat(outs, dim=1).reshape(B, S, H, dh)


def attend_train(p, x: torch.Tensor, positions: torch.Tensor, spec):
    """Full-sequence attention for train/prefill.  Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, spec)
    q, k = _rope_qk(q, k, positions, spec)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    pos = positions if positions.dim() == 2 else positions[0]   # mrope: use t
    if spec.attn_chunk is not None and S > spec.attn_chunk:
        out = _sdpa_chunked(q, k, v, pos, pos, spec.window, scale,
                            q_chunk=spec.attn_chunk, kv_chunk=spec.attn_chunk)
    else:
        mask = _mask(pos, pos, spec.window)
        out = _sdpa(q, k, v, mask, scale)
    out = out.to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["o"])
    return y, (k, v)


# ---------------------------------------------------------------------------
# decode with (windowed ring) KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor        # [B, size, K, dh] (activ dtype, or int8 quantized)
    v: torch.Tensor        # [B, size, K, dh]
    pos_ids: torch.Tensor  # [B, size] int32, -1 where empty
    k_scale: torch.Tensor  # [B, size, K, 1] f32 when int8, else [1] placeholder
    v_scale: torch.Tensor


def kv_cache_size(spec, max_len: int) -> int:
    if spec.window is not None:
        return min(spec.window, max_len)
    prune = max(getattr(spec, "kv_prune", 1), 1)
    return max(max_len // prune, 1)


def _quantized(spec) -> bool:
    return getattr(spec, "kv_cache_dtype", "same") == "int8"


def _quantize_kv(x: torch.Tensor):
    """[..., dh] -> (int8 values, f32 scale[..., 1])."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale).to(dtype)


def init_kv_cache(spec, B: int, max_len: int, dtype, device) -> KVCache:
    size = kv_cache_size(spec, max_len)
    shape = (B, size, spec.n_kv, spec.head_dim)
    pos_ids = torch.full((B, size), -1, dtype=torch.int32, device=device)
    if _quantized(spec):
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            pos_ids=pos_ids,
            k_scale=torch.ones(shape[:-1] + (1,), device=device),
            v_scale=torch.ones(shape[:-1] + (1,), device=device))
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos_ids=pos_ids, k_scale=torch.ones((1,), device=device),
        v_scale=torch.ones((1,), device=device))


def kv_cache_specs(spec, B: int, max_len: int, dtype, mesh, rules) -> KVCache:
    """The cache's :class:`~repro_torch.models.params.TensorSpec`s with
    their shardings (int8 values and float32 scales a slot and head for a
    quantized cache)."""
    size = kv_cache_size(spec, max_len)
    kv_shape = (B, size, spec.n_kv, spec.head_dim)
    kv_axes = ("act_cache_batch", "act_cache_seq", "act_kv_heads", None)
    qdt = torch.int8 if _quantized(spec) else dtype

    def sds(shape, axes, dt):
        return TensorSpec(shape, dt,
                          shd.named_sharding(shape, axes, mesh, rules))

    if _quantized(spec):
        sc_shape = kv_shape[:-1] + (1,)
        k_scale = sds(sc_shape, kv_axes, torch.float32)
        v_scale = sds(sc_shape, kv_axes, torch.float32)
    else:
        k_scale = sds((1,), (None,), torch.float32)
        v_scale = sds((1,), (None,), torch.float32)
    return KVCache(
        k=sds(kv_shape, kv_axes, qdt), v=sds(kv_shape, kv_axes, qdt),
        pos_ids=sds((B, size), ("act_cache_batch", None), torch.int32),
        k_scale=k_scale, v_scale=v_scale)


def attend_decode(p, x: torch.Tensor, pos: int, cache: KVCache, spec):
    """One-token decode: x [B, 1, d], ``pos`` a Python int (uniform across
    the batch).

    Writes the new KV at ``pos % size`` (ring for windowed layers) into the
    cache's tensors and attends over all valid cache entries.  Returns
    (out [B,1,d], the cache)."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, spec)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if spec.pos == "mrope":
        q, k_new = _rope_qk(q, k_new, positions[None].expand(3, B, 1), spec)
    else:
        q, k_new = _rope_qk(q, k_new, positions, spec)

    size = cache.k.shape[1]
    slot = pos % size
    if _quantized(spec):
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        cache.k[:, slot:slot + 1] = kq
        cache.v[:, slot:slot + 1] = vq
        cache.k_scale[:, slot:slot + 1] = ks
        cache.v_scale[:, slot:slot + 1] = vs
        k = _dequantize_kv(cache.k, cache.k_scale, x.dtype)
        v = _dequantize_kv(cache.v, cache.v_scale, x.dtype)
    else:
        cache.k[:, slot:slot + 1] = k_new
        cache.v[:, slot:slot + 1] = v_new
        k, v = cache.k, cache.v
    cache.pos_ids[:, slot:slot + 1] = positions

    scale = float(1.0 / np.sqrt(q.shape[-1]))
    H = q.shape[2]
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, q.shape[-1])
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    pos_ids = cache.pos_ids
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    if spec.window is not None:
        valid &= (pos - pos_ids) < spec.window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, v.float())
    out = out.reshape(B, 1, H, q.shape[-1]).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["o"])
    return y, cache
