"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--device cuda|cpu] [--seed N] [...]``.

Weights are drawn from ``--seed`` (``models.params.init_params``).  The
device is the card unless ``--device cpu`` is given, and the card must be
there; ``--reduced`` defaults to on only with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced
from repro_torch.core.cameo import _device
from repro_torch.models.model import model_defs
from repro_torch.models.params import init_params
from repro_torch.serving.engine import Engine, ServeConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=None)
    args = ap.parse_args(argv)

    device = _device(args.device)
    reduced = args.reduced if args.reduced is not None \
        else device.type == "cpu"
    cfg = get_reduced(args.arch) if reduced else get_config(args.arch)
    params = init_params(model_defs(cfg), args.seed, device, cfg.pdtype())
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=args.new_tokens,
                                          temperature=args.temperature,
                                          seed=args.seed), device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    eng.generate(prompts)
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.name} on {name}: {args.batch * args.new_tokens / dt:.1f} "
          f"tok/s")
    return dict(tokens=out, seconds=dt, device=name)


if __name__ == "__main__":
    main()
