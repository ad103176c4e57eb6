"""kimi-k2-1t-a32b [moe]: 61L d=7168 64H (GQA kv=8) vocab=163840,
MoE 384 experts top-8, expert d_ff=2048 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

Table-faithful: all 61 layers MoE with GQA kv=8 as assigned.  (The released
K2 uses MLA attention, one dense first layer and one shared expert; the
assigned table overrides those — noted in DESIGN.md §Arch-applicability.)
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    d_model=7168, n_layers=61, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163840,
    pattern=(LayerSpec("attn", moe=True),), n_blocks=61,
    n_experts=384, top_k=8, d_ff_expert=2048,
    pos="rope", rope_theta=50000.0, attn_chunk=1024,
    family="moe",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="kimi-k2-1t-a32b-reduced",
        d_model=128, n_layers=3, n_blocks=3, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab=256,
        n_experts=8, top_k=2, d_ff_expert=128, attn_chunk=None,
        param_dtype="float32", activ_dtype="float32", remat="none")
