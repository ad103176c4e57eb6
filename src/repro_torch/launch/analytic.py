"""Analytic per-step FLOP / HBM-traffic model, derived from the config
(port of ``repro.launch.analytic``: the reference's arithmetic term for
term, so the numbers are equal, not merely close).

The port's dry-run (``launch.dryrun``) traces each cell on the meta device
and compiles nothing, so its compute and memory terms come from here, as
the reference's do; ``chip_smoke.py`` reads it for the bounds of its
serving rows and beside its own count of a train step's operations, at
shapes of its own (a shape is a ``SHAPES`` name or a dict of the same
keys).

Conventions:
* flops are *global* (divide by chips for per-device);
* train multiplier: fwd 1x + bwd 2x + full-remat recompute 1x;
* attention scores/probs count 2*2*H*dh*S_kv_avg per token (causal: S/2);
* HBM traffic model (per device): weight streams (post-all-gather
  materialization under FSDP), optimizer state read+write, activation
  tensor reads/writes per layer, attention tiles, KV/state caches.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import SHAPES, LayerSpec, ModelConfig


def _attn_proj_flops(cfg) -> float:
    """qkv + out projection MACs per token (x2 for flops)."""
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return 2.0 * d * dh * (H + 2 * K + H)


def _attn_score_flops(cfg, s_kv: float) -> float:
    """score + weighted-value MACs per token against s_kv keys."""
    H, dh = cfg.n_heads, cfg.head_dim
    return 2.0 * 2.0 * H * dh * s_kv


def _mlp_flops(cfg, ls: LayerSpec) -> float:
    d = cfg.d_model
    if ls.moe:
        e = 2.0 * 3.0 * d * cfg.d_ff_expert * cfg.top_k
        e += 2.0 * d * cfg.n_experts                       # router
        if cfg.n_shared_experts:
            e += 2.0 * 3.0 * d * cfg.d_ff_expert * cfg.n_shared_experts
        return e
    if not ls.mlp:
        return 0.0
    mults = 3.0 if cfg.mlp_kind == "swiglu" else 2.0
    return 2.0 * mults * d * cfg.d_ff


def _mamba_flops(cfg) -> float:
    """per-token MACs (x2): projections + SSD terms."""
    d = cfg.d_model
    di, H, P = cfg.d_inner, cfg.m_heads, cfg.headdim
    G, N, Q = cfg.n_groups, cfg.d_state, cfg.mamba_chunk
    proj = 2.0 * d * (2 * di + 2 * G * N + H) + 2.0 * di * d
    conv = 2.0 * cfg.conv_width * (di + 2 * G * N)
    # within-chunk: scores 2*Q*G*N + L-weighted apply 2*Q*H*P (avg Q/2 -> Q)
    intra = 2.0 * (Q / 2) * G * N + 2.0 * (Q / 2) * H * P
    # chunk states build + emit: 2 * H*P*N each, amortized per token
    states = 2.0 * 2.0 * H * P * N
    return proj + conv + intra + states


def layer_flops_per_token(cfg: ModelConfig, ls: LayerSpec, s_kv: float) -> float:
    if ls.kind == "attn":
        f = _attn_proj_flops(cfg) + _attn_score_flops(cfg, s_kv)
    else:
        f = _mamba_flops(cfg)
    return f + _mlp_flops(cfg, ls)


def model_flops_per_token(cfg: ModelConfig, s_kv: float,
                          decode: bool = False) -> float:
    total = 0.0
    for ls in cfg.all_layers():
        if ls.kind == "attn" and ls.window is not None:
            eff = min(s_kv, ls.window if decode else ls.window / 1.0)
        else:
            eff = s_kv
        total += layer_flops_per_token(cfg, ls, eff)
    total += 2.0 * cfg.d_model * cfg.vocab                 # unembed
    return total


def _shape(shape_name) -> dict:
    """A ``SHAPES`` entry by name, or such a dict itself (``seq_len``,
    ``global_batch``, ``kind``) for a shape of one's own."""
    return SHAPES[shape_name] if isinstance(shape_name, str) else shape_name


def step_flops(cfg: ModelConfig, shape_name: str) -> Dict[str, float]:
    info = _shape(shape_name)
    B, S = info["global_batch"], info["seq_len"]
    kind = info["kind"]
    if kind == "train":
        tokens = B * S
        per_tok = model_flops_per_token(cfg, S / 2.0)
        mult = 4.0 if cfg.remat in ("full", "dots") else 3.0
        flops = per_tok * tokens * mult
    elif kind == "prefill":
        tokens = B * S
        flops = model_flops_per_token(cfg, S / 2.0) * tokens
    else:  # decode: one token against an S-length cache
        tokens = B
        flops = model_flops_per_token(cfg, float(S), decode=True) * tokens
    return {"flops_global": flops, "tokens": tokens}


# ---------------------------------------------------------------------------
# HBM traffic model (per device)
# ---------------------------------------------------------------------------

def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def _param_bytes(cfg: ModelConfig) -> float:
    from repro_torch.configs.registry import param_count
    return float(param_count(cfg)) * _itemsize(cfg.param_dtype)


def _active_param_bytes(cfg: ModelConfig) -> float:
    from repro_torch.configs.registry import active_param_count
    return float(active_param_count(cfg)) * _itemsize(cfg.param_dtype)


def step_hbm_bytes(cfg: ModelConfig, shape_name: str, chips: int,
                   model_par: int = 16) -> Dict[str, float]:
    """Per-device HBM traffic estimate.

    Weight streams: under FSDP+TP the full weights materialize per device
    divided only by the TP (model) factor; they are read for fwd, bwd and
    the remat recompute.  MoE: only routed-expert traffic counts per pass
    on the EP-sharded experts (E/model_par experts resident per device).
    """
    info = _shape(shape_name)
    B, S = info["global_batch"], info["seq_len"]
    kind = info["kind"]
    act_bytes = _itemsize(cfg.activ_dtype)
    p_bytes = _param_bytes(cfg)

    # Weights materialized per device after FSDP all-gather: total/model_par.
    # MoE expert weights are EP-sharded (not FSDP-gathered): resident slice.
    w_per_dev = p_bytes / model_par
    reads = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[kind]
    weight_traffic = w_per_dev * reads
    if kind == "train":
        # grad write (1x) + optimizer state read+write on the local shard
        local = p_bytes / chips
        weight_traffic += w_per_dev + 6.0 * local

    # activations: ~12 intermediate streams of [B_loc, S, d] per layer
    dp = max(chips // model_par, 1)
    if kind == "decode":
        b_loc = max(B / dp, 1.0)
        act_traffic = 12.0 * b_loc * 1 * cfg.d_model * act_bytes * cfg.n_layers
        # cache read (+ write of one slot)
        kv_bytes = act_bytes
        if cfg.kv_cache_dtype == "int8":
            # int8 values + f32 scale per (slot, head)
            kv_bytes = 1.0 + 4.0 / max(cfg.head_dim, 1)
        cache = 0.0
        kv_shards = model_par if cfg.n_kv_heads and \
            cfg.n_kv_heads % model_par == 0 else 1
        m_shards = model_par if cfg.m_heads and \
            cfg.m_heads % model_par == 0 else 1
        for ls in cfg.all_layers():
            if ls.kind == "attn":
                size = min(ls.window, S) if ls.window else \
                    max(S // max(cfg.kv_prune, 1), 1)
                per_seq = 2 * cfg.n_kv_heads * cfg.head_dim * size \
                    * kv_bytes / kv_shards
                cache += per_seq * max(B / dp, 1.0) if B >= dp else per_seq / (dp / B)
            else:
                cache += (cfg.m_heads * cfg.headdim * cfg.d_state * 4
                          + 3 * (cfg.conv_width - 1) * cfg.d_inner) \
                    / m_shards * max(B / dp, 1.0) * 2
        act_traffic += cache
    else:
        toks_loc = B * S / dp
        passes = 3.0 if kind == "train" else 1.0
        act_traffic = 12.0 * toks_loc * cfg.d_model * act_bytes \
            * cfg.n_layers * passes
        # attention tile traffic (flash chunks, f32 scores)
        for ls in cfg.all_layers():
            if ls.kind == "attn":
                s_eff = min(ls.window or S, S)
                act_traffic += 2.0 * toks_loc * (cfg.n_heads / 1.0) * s_eff \
                    * 4 / max(model_par, 1) * (2 if kind == "train" else 1) \
                    * 0.5  # causal half, streamed tiles
    return {"hbm_bytes_per_device": weight_traffic + act_traffic,
            "weight_traffic": weight_traffic, "act_traffic": act_traffic}
