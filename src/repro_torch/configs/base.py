"""Architecture config schema (port of ``repro.configs.base``):
ModelConfig + per-layer LayerSpec patterns.

A model is ``n_blocks`` repetitions of ``pattern`` (a tuple of LayerSpecs)
plus an optional ``remainder``.  The block parameters are stacked
``[n_blocks, ...]`` as in the reference; the port walks the block axis in a
Python loop.  The fields and their defaults are the reference's; only
``pdtype``/``adtype`` differ, returning torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"            # "attn" | "mamba"
    window: Optional[int] = None  # sliding-window size (attn only)
    moe: bool = False             # MoE MLP instead of dense
    mlp: bool = True              # False: mixer-only block (pure Mamba2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...]
    n_blocks: int
    remainder: Tuple[LayerSpec, ...] = ()
    # attention
    qk_norm: bool = False
    qkv_bias: bool = False
    pos: str = "rope"             # rope | mrope | sinusoidal | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    attn_chunk: Optional[int] = None   # flash-style chunk (long prefill)
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3
    moe_impl: str = "scatter"     # scatter | a2a (shard_map all-to-all EP)
    # mamba
    d_state: int = 0
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    mamba_chunk: int = 128
    # misc
    mlp_kind: str = "swiglu"      # swiglu | gelu
    tie_embeddings: bool = False
    scale_embed: bool = False
    sandwich_norm: bool = False
    norm_eps: float = 1e-6
    frontend: Optional[str] = None    # None | "vision_stub" | "audio_stub"
    n_patches: int = 0                # vision stub: prefix embeddings
    # execution
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"
    remat: str = "full"               # none | full | dots
    kv_cache_dtype: str = "same"      # same | int8 (quantized KV cache)
    kv_prune: int = 1                 # CAMEO cache pruning: keep 1/kv_prune
    # family tag for applicability notes
    family: str = "dense"             # dense | moe | ssm | hybrid | vlm | audio

    def __post_init__(self):
        assert self.n_layers == self.n_blocks * len(self.pattern) + \
            len(self.remainder), (
                self.name, self.n_layers, self.n_blocks, len(self.pattern),
                len(self.remainder))

    # ---- derived ----
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def m_heads(self) -> int:
        return self.d_inner // self.headdim if self.headdim else 0

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activ_dtype)

    def all_layers(self) -> Tuple[LayerSpec, ...]:
        return self.pattern * self.n_blocks + self.remainder

    def supports_long_context(self) -> bool:
        """True when every layer is sub-quadratic-capable (SSM or windowed
        attention) or the arch is hybrid with O(1)/O(W) per-layer state."""
        return all(
            ls.kind == "mamba" or ls.window is not None
            for ls in self.all_layers()
        ) or self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class LayerCtx:
    """Merged view of ModelConfig + LayerSpec handed to layer functions."""
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    window: Optional[int]
    pos: str
    rope_theta: float
    mrope_sections: Tuple[int, ...]
    attn_chunk: Optional[int]
    kv_cache_dtype: str
    kv_prune: int
    # moe
    n_experts: int
    top_k: int
    capacity_factor: float
    aux_loss_coef: float
    router_z_coef: float
    # mamba
    d_inner: int
    m_heads: int
    headdim: int
    n_groups: int
    d_state: int
    conv_width: int
    mamba_chunk: int


def layer_ctx(cfg: ModelConfig, ls: LayerSpec) -> LayerCtx:
    return LayerCtx(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, window=ls.window, pos=cfg.pos,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        attn_chunk=cfg.attn_chunk, kv_cache_dtype=cfg.kv_cache_dtype,
        kv_prune=cfg.kv_prune,
        n_experts=cfg.n_experts, top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor,
        aux_loss_coef=cfg.aux_loss_coef, router_z_coef=cfg.router_z_coef,
        d_inner=cfg.d_inner, m_heads=cfg.m_heads, headdim=cfg.headdim,
        n_groups=cfg.n_groups, d_state=cfg.d_state,
        conv_width=cfg.conv_width, mamba_chunk=cfg.mamba_chunk,
    )


# input shapes assigned to the LM pool (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
