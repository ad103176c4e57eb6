"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
5:1 local(1024-window):global interleave, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
head_dim=128 (gemma3 decouples from d/H); sandwich norms; qk-norm;
embeddings scaled by sqrt(d) and tied (as in Gemma).
Long-context capable: local layers cache O(window); decode over a 512k
global-layer cache is O(n) per token.
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec("attn", window=1024)
_GLOBAL = LayerSpec("attn")

CONFIG = ModelConfig(
    name="gemma3-27b",
    d_model=5376, n_layers=62, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL), n_blocks=10,
    remainder=(_LOCAL, _LOCAL),
    qk_norm=True, sandwich_norm=True, scale_embed=True, tie_embeddings=True,
    pos="rope", rope_theta=1_000_000.0, attn_chunk=1024,
    family="dense",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-27b-reduced",
        d_model=128, n_layers=8, n_blocks=1,
        pattern=(dataclasses.replace(_LOCAL, window=16),) * 5 + (_GLOBAL,),
        remainder=(dataclasses.replace(_LOCAL, window=16),) * 2,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=256,
        attn_chunk=None, param_dtype="float32", activ_dtype="float32",
        remat="none")
