"""State carried between the JAX package and the port.

CAMEO has no weights: what one package can hand the other is its
configuration and the rounds-mode loop carry.  ``config_from_dict`` reads
``dataclasses.asdict`` of a JAX ``CameoConfig``; the carry travels as
numpy arrays in JAX's 13-tuple order
``(xr, alive, prev, nxt, y, tbl, alpha, dev, rounds, done, blocked,
retried, saw_c)``.  This lets a test start the port from the reference's
exact state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cameo import CameoConfig

_BACKEND = {"pallas": "cuda"}


def config_from_dict(d: dict) -> CameoConfig:
    """The port's ``CameoConfig`` from a JAX config's field dict (the
    ``"pallas"`` backend maps to ``"cuda"``)."""
    names = {f.name for f in dataclasses.fields(CameoConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"fields the port's CameoConfig lacks: {sorted(unknown)}")
    d = dict(d)
    d["backend"] = _BACKEND.get(d.get("backend", "auto"),
                                d.get("backend", "auto"))
    return CameoConfig(**d)


def carry_from_numpy(arrays, device) -> tuple:
    """The rounds carry as tensors on ``device`` (dtypes as given)."""
    if len(arrays) != 13:
        raise ValueError(f"a rounds carry has 13 fields, got {len(arrays)}")
    return tuple(torch.from_numpy(np.array(a, copy=True)).to(device)
                 for a in arrays)


def carry_to_numpy(carry) -> tuple:
    """The rounds carry as numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in carry)
