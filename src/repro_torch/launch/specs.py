"""Per-architecture training defaults (port of ``repro.launch.specs``'s
``default_train_config``; the reference's sharding specs are not ported:
one device)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.train.step import TrainConfig


def default_train_config(cfg: ModelConfig) -> TrainConfig:
    """Adafactor (factored second moments) for the >=200B MoE and hybrid
    configs, so their optimizer state fits; AdamW otherwise."""
    if cfg.n_experts and cfg.name.startswith(("kimi", "jamba", "qwen3-moe")):
        return TrainConfig(optimizer="adafactor")
    return TrainConfig(optimizer="adamw")
