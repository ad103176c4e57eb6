"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
M-RoPE (sections 16/24/24 over half of head_dim=128), dynamic resolution.
[arXiv:2409.12191; hf]

The vision tower is a STUB per the brief: ``input_specs()`` provides
precomputed patch embeddings [B, n_patches, d] that replace the prefix of
the token embedding sequence; M-RoPE positions default to text-style.
qkv_bias=True (Qwen2 attention biases); tied embeddings.
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    d_model=1536, n_layers=28, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936,
    pattern=(LayerSpec("attn"),), n_blocks=28,
    qkv_bias=True, tie_embeddings=True,
    pos="mrope", mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    attn_chunk=1024,
    frontend="vision_stub", n_patches=256,
    family="vlm",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-2b-reduced",
        d_model=128, n_layers=3, n_blocks=3, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=256, mrope_sections=(8, 4, 4),
        n_patches=8, attn_chunk=None,
        param_dtype="float32", activ_dtype="float32", remat="none")
