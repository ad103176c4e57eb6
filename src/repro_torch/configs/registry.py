"""Architecture registry (port of ``repro.configs.registry``): ``--arch
<id>`` resolution and parameter accounting.

``LONG_CONTEXT_ARCHS`` names the archs that run the ``long_500k`` cell
(sub-quadratic capable); pure full-attention archs skip it.  The counts
come from the port's own ``model_defs`` (shape arithmetic, nothing
allocated), for every architecture.
"""
from __future__ import annotations

import importlib
import math

from repro_torch.configs.base import SHAPES, ModelConfig

_MODULES = {
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_MODULES)

# long_500k runs only for sub-quadratic-capable archs (SSM / hybrid /
# sliding-window); pure full-attention archs skip it by assignment.
LONG_CONTEXT_ARCHS = ("gemma3-27b", "mamba2-2.7b", "jamba-1.5-large-398b")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.reduced()


def cells(include_skipped: bool = False):
    """All assigned (arch, shape) dry-run cells.

    Yields (arch, shape_name, runnable: bool)."""
    for arch in ARCH_IDS:
        for shape in SHAPES:
            runnable = shape != "long_500k" or arch in LONG_CONTEXT_ARCHS
            if runnable or include_skipped:
                yield arch, shape, runnable


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``'s model, from shapes alone (nothing is
    allocated)."""
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import count_params
    return count_params(model_defs(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters per token: an MoE layer counts ``top_k`` of its
    ``n_experts`` experts (its shared expert whole), as the reference's
    ``active_param_count`` does."""
    total = param_count(cfg)
    if cfg.n_experts == 0:
        return total
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import _map_defs

    expert_total = 0

    def visit(path, d):
        nonlocal expert_total
        if "moe" in path and path[-1] in ("wi_gate", "wi_up", "wo"):
            expert_total += math.prod(d.shape)

    _map_defs(visit, model_defs(cfg))
    return int(total - expert_total * (1.0 - cfg.top_k / cfg.n_experts))
