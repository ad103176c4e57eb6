"""Train-step builder (port of ``repro.train.step``): loss, gradients by
autograd, the optimizer update, microbatch accumulation.

``build_train_step(cfg, tcfg)`` returns ``train_step(params, opt_state,
batch, step) -> (params, opt_state, metrics)``.  The parameters must
require grad (``ParamTree.requires_grad_(True)``; ``init_params`` leaves
them frozen, as serving wants); the step writes the updated values into
them and into the optimizer state in place.  With ``num_microbatches``
> 1 the batch is split on its leading axis and each microbatch's
gradients are added in float32 divided by the count, as the reference's
scan adds them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward
from repro_torch.optim.adafactor import (AdafactorConfig, adafactor_init,
                                        adafactor_update)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.tree import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"        # adamw | adafactor
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    schedule: str = "warmup_cosine"
    z_loss: float = 1e-4
    num_microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()
    adafactor: AdafactorConfig = AdafactorConfig()


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    z_loss_coef: float = 0.0) -> torch.Tensor:
    """Causal LM loss: predict tokens[t+1] from logits[t], in float32.

    The gold logit is picked with ``gather``; the reference contracts a
    one-hot (for its vocab-sharded logits), which picks the same value
    wherever the logits are finite."""
    logits = logits[:, :-1, :].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    if z_loss_coef:
        nll = nll + z_loss_coef * torch.mean(logz ** 2)
    return nll


def loss_fn(params, cfg: ModelConfig, tcfg: TrainConfig, batch, *,
            unbind=None):
    """(loss + aux, (loss, aux)); ``unbind`` as ``models.model.forward``
    takes it."""
    logits, aux = forward(params, cfg, batch, unbind=unbind)
    loss = next_token_loss(logits, batch["tokens"], tcfg.z_loss)
    return loss + aux.float(), (loss, aux)


def init_opt_state(params, tcfg: TrainConfig):
    if tcfg.optimizer == "adamw":
        return adamw_init(params, tcfg.adamw)
    if tcfg.optimizer == "adafactor":
        return adafactor_init(params, tcfg.adafactor)
    raise ValueError(tcfg.optimizer)


def _grads(params, cfg, tcfg, batch, unbind):
    """(total, loss, aux, gradients in the parameters' tree) of one
    batch; a leaf the loss does not reach gets zeros, as JAX's grad gives
    it."""
    plist = leaves(params)
    with torch.enable_grad():
        total, (loss, aux) = loss_fn(params, cfg, tcfg, batch, unbind=unbind)
        gs = torch.autograd.grad(total, plist, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, plist)]
    return total.detach(), loss.detach(), aux.detach(), unflatten(params, gs)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                     unbind=None) -> Callable:
    """The train step for ``cfg`` under ``tcfg``; ``unbind=False`` reads
    the stacked block leaves as views ``[i]`` (serving's form, to time
    against the default)."""
    sched = SCHEDULES[tcfg.schedule]

    def compute_grads(params, batch):
        nm = tcfg.num_microbatches
        if nm <= 1:
            return _grads(params, cfg, tcfg, batch, unbind)
        micro = {k: v.reshape((nm, v.shape[0] // nm) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc_g, acc_t, acc_l, acc_a = None, 0.0, 0.0, 0.0
        for i in range(nm):
            total, loss, aux, grads = _grads(
                params, cfg, tcfg, {k: v[i] for k, v in micro.items()},
                unbind)
            gl = [g.float() / nm for g in leaves(grads)]
            acc_g = gl if acc_g is None else [a + g for a, g in
                                              zip(acc_g, gl)]
            acc_t = acc_t + total / nm
            acc_l = acc_l + loss / nm
            acc_a = acc_a + aux / nm
        return acc_t, acc_l, acc_a, unflatten(params, acc_g)

    def train_step(params, opt_state, batch, step):
        total, loss, aux, grads = compute_grads(params, batch)
        lr = sched(step, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                   total=tcfg.total_steps)
        if tcfg.optimizer == "adamw":
            params, opt_state, gnorm = adamw_update(
                grads, opt_state, params, lr, tcfg.adamw)
        else:
            params, opt_state = adafactor_update(
                grads, opt_state, params, lr, tcfg.adafactor)
            gnorm = torch.zeros((), dtype=torch.float32)
        metrics = {"loss": loss, "total_loss": total, "aux_loss": aux,
                   "lr": lr, "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step
