"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=1536.  qk_norm.  [hf:Qwen/Qwen3-30B-A3B; hf]
All layers are MoE (no dense MLP layers).
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    d_model=4096, n_layers=94, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    pattern=(LayerSpec("attn", moe=True),), n_blocks=94,
    n_experts=128, top_k=8, d_ff_expert=1536,
    qk_norm=True,
    pos="rope", rope_theta=1_000_000.0, attn_chunk=1024,
    family="moe",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-235b-a22b-reduced",
        d_model=128, n_layers=3, n_blocks=3, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab=256,
        n_experts=8, top_k=2, d_ff_expert=128, attn_chunk=None,
        param_dtype="float32", activ_dtype="float32", remat="none")
