"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave, MoE on
every other layer.  [arXiv:2403.19887; hf]

Block pattern (period 8, 9 blocks): one attention layer per 8 (index 4),
MoE MLP on odd indices, dense MLP elsewhere.  Mamba sublayers: d_state=16,
headdim=128 (128 heads), 8 B/C groups.
Long-context capable: O(1) SSM state on 7/8 of layers; attention layers
decode in O(n) reads over the cache.
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_M = LayerSpec("mamba")                 # mamba + dense MLP
_MM = LayerSpec("mamba", moe=True)      # mamba + MoE
_A = LayerSpec("attn")                  # attention + dense MLP
_AM = LayerSpec("attn", moe=True)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    d_model=8192, n_layers=72, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    pattern=(_M, _MM, _M, _MM, _A, _MM, _M, _MM), n_blocks=9,
    n_experts=16, top_k=2, d_ff_expert=24576,
    d_state=16, expand=2, headdim=128, n_groups=8, conv_width=4,
    mamba_chunk=256,
    pos="rope", rope_theta=1_000_000.0, attn_chunk=1024,
    family="hybrid",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-1.5-large-398b-reduced",
        d_model=128, n_layers=8, n_blocks=1, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=256,
        n_experts=4, top_k=2, d_ff_expert=256,
        d_state=16, headdim=32, n_groups=2, mamba_chunk=16, attn_chunk=None,
        param_dtype="float32", activ_dtype="float32", remat="none")
