"""Batched serving engine (port of ``repro.serving.engine``): prefill and a
decode loop under ``torch.inference_mode()``.

Greedy and temperature sampling with per-sequence EOS tracking, as the
reference.  Greedy decoding is the reference's argmax (ties to the lowest
id).  Sampling draws ``torch.multinomial`` from a ``torch.Generator`` on the
engine's device seeded with ``ServeConfig.seed``: deterministic for a seed,
but not ``jax.random.categorical``'s draws, so sampled tokens differ from
the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cameo import _device
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.params import ParamTree


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 = greedy
    eos_id: Optional[int] = None
    seed: int = 0


class Engine:
    """``Engine(cfg, params, scfg, device="cuda")``: ``params`` (a
    ``ParamTree``) is moved to ``device``, which must exist: asking for the
    card without one raises.  After each ``generate``, ``stats`` holds its
    host seconds to the first token on the host (``prefill_s``: prefill and
    the first sample) and after it (``decode_s``, over ``decode_steps``
    steps)."""

    def __init__(self, cfg: ModelConfig, params: ParamTree,
                 scfg: ServeConfig, device="cuda"):
        self.device = _device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.scfg = scfg
        self.stats = {}

    def _sample(self, logits: torch.Tensor, gen: torch.Generator):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits[:, -1, :], dim=-1)
        probs = torch.softmax(logits[:, -1, :] / self.scfg.temperature, -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray) -> np.ndarray:
        """prompts: [B, S] int (left-aligned, same length).  Returns
        [B, max_new_tokens] generated ids (EOS-padded)."""
        cfg, scfg = self.cfg, self.scfg
        B, S = prompts.shape
        t0 = time.perf_counter()
        max_len = S + scfg.max_new_tokens
        batch = {"tokens": torch.as_tensor(np.asarray(prompts),
                                           device=self.device).long()}
        logits, caches = prefill(self.params, cfg, batch, max_len=max_len)
        gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        out = np.full((B, scfg.max_new_tokens), scfg.eos_id or 0, np.int32)
        done = np.zeros((B,), bool)
        tok = self._sample(logits, gen)
        t_first, steps = None, 0
        for i in range(scfg.max_new_tokens):
            t = tok.cpu().numpy()
            t_first = t_first or time.perf_counter()
            out[:, i] = np.where(done, out[:, i], t)
            if scfg.eos_id is not None:
                done |= t == scfg.eos_id
                if done.all():
                    break
            logits, caches = decode_step(self.params, cfg, tok[:, None],
                                         caches, S + i)
            tok = self._sample(logits, gen)
            steps += 1
        t_end = time.perf_counter()
        t_first = t_first or t_end
        self.stats = dict(prefill_s=t_first - t0, decode_s=t_end - t_first,
                          decode_steps=steps)
        return out
