"""Fault-tolerant training loop (port of ``repro.train.loop``).

* resumes from the latest intact checkpoint (corrupt or partial ones are
  skipped by the manifest check);
* SIGTERM triggers a final synchronous checkpoint at the step it stops on
  (preemption);
* periodic async checkpoints off the critical path, each joined before
  the next;
* data is a pure function of the step (restart-consistent);
* ``history`` holds the metrics every ``log_every`` steps and at the last
  (the only host reads of the metrics).

The parameters are trained in place: the leaves of the tree passed in (a
``ParamTree``) are set to require grad and hold the trained values
afterwards (copy it
first to keep the initial weights); a resume replaces it with the
restored one, which is returned.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable, Optional

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.train.step import TrainConfig, build_train_step, init_opt_state
from repro_torch.tree import leaves


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, lcfg: LoopConfig,
               params, batch_fn: Callable[[int], dict],
               log_fn: Callable[[int, dict], None] | None = None):
    """Run the loop; returns (params, opt_state, history)."""
    step_fn = build_train_step(cfg, tcfg)
    for p in leaves(params):
        p.requires_grad_(True)
    opt_state = init_opt_state(params, tcfg)
    start = 0
    if lcfg.ckpt_dir:
        latest = ckpt.latest_step(lcfg.ckpt_dir)
        if latest is not None:
            (params, opt_state), _ = ckpt.restore(
                lcfg.ckpt_dir, latest, template=(params, opt_state))
            start = latest
            print(f"[train] resumed from step {latest}")

    stop = {"now": False}

    def handler(signum, frame):
        stop["now"] = True

    prev_term = signal.signal(signal.SIGTERM, handler)
    history = []
    pending_save = None
    try:
        for step in range(start, lcfg.steps):
            batch = batch_fn(step)
            params, opt_state, metrics = step_fn(
                params, opt_state, batch, step)
            if step % lcfg.log_every == 0 or step == lcfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **m})
                if log_fn:
                    log_fn(step, m)
            if lcfg.ckpt_dir and (step + 1) % lcfg.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save_async(
                    lcfg.ckpt_dir, step + 1, (params, opt_state),
                    keep=lcfg.keep)
            if stop["now"]:
                print(f"[train] SIGTERM at step {step}: checkpointing")
                if pending_save is not None:
                    pending_save.join()
                if lcfg.ckpt_dir:
                    ckpt.save(lcfg.ckpt_dir, step + 1, (params, opt_state),
                              keep=lcfg.keep)
                break
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        if pending_save is not None:
            pending_save.join()
    return params, opt_state, history
