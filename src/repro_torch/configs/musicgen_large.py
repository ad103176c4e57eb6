"""musicgen-large [audio]: 48L d=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Backbone only per the brief: the EnCodec tokenizer/delay-pattern frontend is
a STUB — ``input_specs()`` feeds precomputed frame-token streams.  Sinusoidal
positions, GELU MLP (MusicGen's transformer), head_dim=64.

This is the arch whose inputs are literally sensor-like time series (audio
frames) — the CAMEO data plane applies directly (examples/audio_ingest).
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    d_model=2048, n_layers=48, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048,
    pattern=(LayerSpec("attn"),), n_blocks=48,
    pos="sinusoidal", mlp_kind="gelu", attn_chunk=1024,
    frontend="audio_stub",
    family="audio",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-large-reduced",
        d_model=128, n_layers=3, n_blocks=3, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=256, attn_chunk=None,
        param_dtype="float32", activ_dtype="float32", remat="none")
