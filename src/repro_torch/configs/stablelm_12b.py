"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; hf]  head_dim = d/H = 160.
Note: StableLM-2 uses LayerNorm+bias; we use RMSNorm uniformly (DESIGN.md §2).
"""
import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    d_model=5120, n_layers=40, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352,
    pattern=(LayerSpec("attn"),), n_blocks=40,
    pos="rope", rope_theta=10000.0, attn_chunk=1024,
    family="dense",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-12b-reduced",
        d_model=128, n_layers=3, n_blocks=3, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=256, attn_chunk=None,
        param_dtype="float32", activ_dtype="float32", remat="none")
