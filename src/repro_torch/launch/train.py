"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps N --batch B --seq S --reduced --multi-pod --ckpt-dir DIR
--peak-lr LR --device cuda|cpu --seed N]``.

Weights are drawn from ``--seed`` (``models.params.init_params``, on the
card there), batches are ``data.pipeline.token_batch`` of the step.  The
device is the card unless ``--device cpu`` is given, and the card must be
there; ``--reduced`` defaults to on only with ``--device cpu``.  As the
reference's launcher, it uses no mesh below 256 cards (the processes of
an initialised default group, else one); from 256 it makes the production
mesh (``--multi-pod``: 2 x 16 x 16) and the default rules active, which
the port's models do not read yet (ROADMAP: the zoo sharded through
``DTensor``).  Fault tolerance (resume, SIGTERM checkpointing) comes from
``train.loop``.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch import sharding as shd
from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced
from repro_torch.core.cameo import _device
from repro_torch.data.pipeline import token_batch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import default_train_config
from repro_torch.models.model import model_defs
from repro_torch.models.params import init_params
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig


def main(argv=None) -> list:
    """Run the loop; returns its history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=None, help="the reduced config (default on the "
                                       "CPU)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = _device(args.device)
    reduced = args.reduced if args.reduced is not None \
        else device.type == "cpu"
    cfg = get_reduced(args.arch) if reduced else get_config(args.arch)
    tcfg = TrainConfig(optimizer=default_train_config(cfg).optimizer,
                       peak_lr=args.peak_lr,
                       warmup=max(args.steps // 20, 2),
                       total_steps=args.steps)

    cards = dist.get_world_size() if dist.is_initialized() else 1
    use_mesh = cards >= 256
    ctx_mesh = make_production_mesh(multi_pod=args.multi_pod, real=True,
                                    device_type=device.type) \
        if use_mesh else None
    rules = shd.default_rules(multi_pod=args.multi_pod) if use_mesh else None

    def batch_fn(step):
        return token_batch(cfg, args.batch, args.seq, step, args.seed, device)

    with shd.use_sharding(ctx_mesh, rules):
        params = init_params(model_defs(cfg), args.seed, device, cfg.pdtype(),
                             draw="device" if device.type == "cuda" else "cpu")
        lcfg = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=max(args.steps // 4, 10),
                          log_every=max(args.steps // 20, 1))
        _, _, history = train_loop(
            cfg, tcfg, lcfg, params, batch_fn,
            log_fn=lambda s, m: print(
                f"step {s:5d} loss {m['loss']:.4f} "
                f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}", flush=True))
    return history


if __name__ == "__main__":
    main()
