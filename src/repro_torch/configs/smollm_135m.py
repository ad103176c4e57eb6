"""smollm-135m [dense]: 30L d=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
llama-arch small; head_dim=64; tied embeddings.
[hf:HuggingFaceTB/SmolLM-135M; hf]
Note: 9 query heads / 3 KV heads are not divisible by a 16-way model axis —
the sharding divisibility guard replicates them (see roofline notes).
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    d_model=576, n_layers=30, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152,
    pattern=(LayerSpec("attn"),), n_blocks=30,
    tie_embeddings=True,
    pos="rope", rope_theta=10000.0, attn_chunk=1024,
    family="dense",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-135m-reduced",
        d_model=96, n_layers=3, n_blocks=3, n_heads=3, n_kv_heads=1,
        head_dim=32, d_ff=192, vocab=256, attn_chunk=None,
        param_dtype="float32", activ_dtype="float32", remat="none")
