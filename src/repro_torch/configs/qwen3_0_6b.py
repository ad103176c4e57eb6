"""qwen3-0.6b [dense]: 28L d=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
qk_norm, GQA, head_dim=128, tied embeddings.  [hf:Qwen/Qwen3-8B; hf]
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    d_model=1024, n_layers=28, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab=151936,
    pattern=(LayerSpec("attn"),), n_blocks=28,
    qk_norm=True, tie_embeddings=True,
    pos="rope", rope_theta=1_000_000.0, attn_chunk=1024,
    family="dense",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-0.6b-reduced",
        d_model=128, n_layers=3, n_blocks=3, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=256, attn_chunk=None,
        param_dtype="float32", activ_dtype="float32", remat="none")
