"""mamba2-2.7b [ssm]: 64L d=2560 (attn-free) vocab=50280, ssm_state=128.
SSD (state-space duality), expand=2 -> d_inner=5120, headdim=64 (80 heads),
n_groups=1, conv width 4.  Mixer-only blocks (no MLP), tied embeddings.
[arXiv:2405.21060; unverified]
Long-context capable: O(1) recurrent state per layer.
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    d_model=2560, n_layers=64, n_heads=1, n_kv_heads=1, head_dim=1,
    d_ff=0, vocab=50280,
    pattern=(LayerSpec("mamba", mlp=False),), n_blocks=64,
    d_state=128, expand=2, headdim=64, n_groups=1, conv_width=4,
    mamba_chunk=256,
    tie_embeddings=True, pos="none",
    family="ssm",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-2.7b-reduced",
        d_model=128, n_layers=3, n_blocks=3, d_state=16, headdim=32,
        mamba_chunk=16, vocab=256,
        param_dtype="float32", activ_dtype="float32", remat="none")
