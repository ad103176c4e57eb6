"""Input stand-ins for every (arch x shape) dry-run cell (port of
``repro.launch.specs``): ``TensorSpec``s (shape, dtype, sharding; nothing
allocated, ``.meta()`` for a meta-device tensor), and the per-architecture
training defaults.

``train_*`` shapes feed the train step; ``prefill_*`` feed ``prefill``;
``decode_*`` / ``long_*`` feed ``decode_step`` (one token against a
seq_len cache).
"""
from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.models.model import cache_specs, model_defs
from repro_torch.models.params import TensorSpec, abstract_params
from repro_torch.optim.adafactor import AdafactorState, _factored
from repro_torch.optim.adamw import AdamWState, _dtype
from repro_torch.tree import tree_map
from repro_torch.train.step import TrainConfig


def _sds(shape, dtype, axes, mesh, rules) -> TensorSpec:
    return TensorSpec(shape, dtype,
                      shd.named_sharding(shape, axes, mesh, rules))


def batch_specs(cfg: ModelConfig, shape_name: str, mesh, rules) -> dict:
    info = SHAPES[shape_name]
    B, S = info["global_batch"], info["seq_len"]
    kind = info["kind"]
    if kind in ("train", "prefill"):
        out = {"tokens": _sds((B, S), torch.int32,
                              ("act_batch", "act_seq"), mesh, rules)}
        if cfg.frontend == "vision_stub" and cfg.n_patches:
            out["patch_embeds"] = _sds(
                (B, cfg.n_patches, cfg.d_model), cfg.adtype(),
                ("act_batch", None, "act_embed"), mesh, rules)
        return out
    # decode: one new token against a seq_len cache
    token = _sds((B, 1), torch.int32, ("act_batch", None), mesh, rules)
    caches = cache_specs(cfg, B, S, mesh, rules)
    pos = TensorSpec((), torch.int32)
    return {"token": token, "caches": caches, "pos": pos}


def params_abstract(cfg: ModelConfig, mesh, rules):
    return abstract_params(model_defs(cfg), mesh, rules,
                           param_dtype=cfg.pdtype())


def opt_state_abstract(params_abs, tcfg: TrainConfig, mesh):
    """Optimizer-state stand-ins mirroring the parameters' shardings.

    AdamW: m and v mirror the parameters (in ``state_dtype`` when set).
    Adafactor: the row and column factors take the parameter's spec minus
    the reduced dimension."""

    def spec_of(p):
        return p.sharding.spec if p.sharding is not None else shd.P()

    step = TensorSpec((), torch.int32, shd.NamedSharding(mesh, shd.P()))
    if tcfg.optimizer == "adamw":
        dt = tcfg.adamw.state_dtype

        def mirror(p):
            return TensorSpec(p.shape, _dtype(dt) if dt else p.dtype,
                              p.sharding)

        return AdamWState(m=tree_map(mirror, params_abs),
                          v=tree_map(mirror, params_abs), step=step)

    acfg = tcfg.adafactor

    def vr_abs(p):
        spec = tuple(spec_of(p))
        if _factored(p.shape, acfg):
            return TensorSpec(p.shape[:-1], torch.float32,
                              shd.NamedSharding(mesh, shd.P(*spec[:-1])))
        return TensorSpec(p.shape, torch.float32, p.sharding)

    def vc_abs(p):
        spec = tuple(spec_of(p))
        if _factored(p.shape, acfg):
            return TensorSpec(
                p.shape[:-2] + p.shape[-1:], torch.float32,
                shd.NamedSharding(mesh, shd.P(*(spec[:-2] + spec[-1:]))))
        return TensorSpec((1,), torch.float32,
                          shd.NamedSharding(mesh, shd.P()))

    return AdafactorState(vr=tree_map(vr_abs, params_abs),
                          vc=tree_map(vc_abs, params_abs), step=step)


def default_train_config(cfg: ModelConfig) -> TrainConfig:
    """Adafactor (factored second moments) for the >=200B MoE and hybrid
    configs, so their optimizer state fits; AdamW otherwise."""
    if cfg.n_experts and cfg.name.startswith(("kimi", "jamba", "qwen3-moe")):
        return TrainConfig(optimizer="adafactor")
    return TrainConfig(optimizer="adamw")
