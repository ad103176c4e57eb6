"""State carried between the JAX package and the port.

CAMEO has no weights: what one package can hand the other is its
configuration and the loop carries.  ``config_from_dict`` reads
``dataclasses.asdict`` of a JAX ``CameoConfig``.  The rounds carry travels
as numpy arrays in JAX's 13-tuple order ``(xr, alive, prev, nxt, y, tbl,
alpha, dev, rounds, done, blocked, retried, saw_c)``.  The port's rounds
carry always has a leading lane axis: JAX's batched carry (``vmap`` of the
per-series one, as its ``compress_batch`` holds it) crosses as it is
(``batched=True``), a per-series carry gains a lane axis of one on the
way in and loses it on the way out.  The sequential carry
in JAX's 10-tuple order ``(xr, alive, prev, nxt, imp, agg, y, dev, it,
done)``, with ``agg`` the five per-lag aggregate rows (JAX's
``Aggregates``) or the packed ``[5, L]`` table.  This lets a test start the
port from the reference's exact state.  The model zoo has weights:
``params_from_numpy`` turns the JAX package's parameter tree into the
port's module, checking every key and shape, and
``opt_state_from_numpy``/``opt_state_to_numpy`` carry an optimizer's state
(``AdamWState``, ``AdafactorState``) across.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cameo import CameoConfig, _device

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


def carry_from_numpy(arrays, device, *, batched: bool = False) -> tuple:
    """The port's rounds carry as tensors on ``device`` (dtypes as given)
    from JAX's: batched (every field with a leading lane axis) or, by
    default, one series (given a lane axis of one)."""
    if len(arrays) != 13:
        raise ValueError(f"a rounds carry has 13 fields, got {len(arrays)}")
    out = tuple(torch.from_numpy(np.array(a, copy=True)).to(device)
                for a in arrays)
    return out if batched else tuple(t[None] for t in out)


def carry_to_numpy(carry, *, batched: bool = False) -> tuple:
    """The port's rounds carry as numpy arrays in JAX's form: batched, or
    (by default) the one series of a one-lane carry."""
    if not batched and carry[0].shape[0] != 1:
        raise ValueError(f"a carry of {carry[0].shape[0]} lanes is not one "
                         f"series; pass batched=True")
    return tuple(t.detach().cpu().numpy() if batched
                 else t[0].detach().cpu().numpy() for t in carry)


def sequential_carry_from_numpy(arrays, device) -> tuple:
    """The sequential carry as tensors on ``device``; ``agg`` becomes the
    port's ``[5, L]`` table."""
    if len(arrays) != 10:
        raise ValueError(f"a sequential carry has 10 fields, got {len(arrays)}")
    arrays = list(arrays)
    arrays[5] = np.stack([np.asarray(a) for a in arrays[5]])
    return tuple(torch.from_numpy(np.array(a, copy=True)).to(device)
                 for a in arrays)


def sequential_carry_to_numpy(carry) -> tuple:
    """The sequential carry as numpy arrays (``agg`` as the ``[5, L]``
    table)."""
    return tuple(t.detach().cpu().numpy() for t in carry)


def _numpy_leaf(a) -> np.ndarray:
    a = np.asarray(a)
    # ml_dtypes' bfloat16 (the JAX package's arrays) has no torch twin in
    # numpy: widen it exactly to float32
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def params_from_numpy(tree: dict, cfg, device="cuda"):
    """The port's parameter module (``models.params.ParamTree``) on
    ``device`` (the card unless the caller passes ``"cpu"``; raises without
    one) from the JAX package's parameters for ``cfg``, given as a
    nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``).

    Every key and shape is checked against the port's ``model_defs(cfg)``:
    a missing, extra or misshapen leaf raises ``ValueError``.  Values are
    cast to ``cfg.pdtype()``."""
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import ParamDef, ParamTree

    device = _device(device)

    def build(defs, node, path):
        if isinstance(defs, ParamDef):
            if isinstance(node, dict):
                raise ValueError(f"{'.'.join(path)}: a subtree where the "
                                 f"model has a parameter")
            a = _numpy_leaf(node)
            if tuple(a.shape) != tuple(defs.shape):
                raise ValueError(f"{'.'.join(path)}: shape {tuple(a.shape)}, "
                                 f"the model's is {tuple(defs.shape)}")
            return torch.from_numpy(np.array(a, copy=True)).to(
                device=device, dtype=cfg.pdtype())
        if not isinstance(node, dict):
            raise ValueError(f"{'.'.join(path)}: a leaf where the model has "
                             f"a subtree")
        if set(node) != set(defs):
            raise ValueError(
                f"{'.'.join(path) or '<root>'}: keys missing "
                f"{sorted(set(defs) - set(node))}, unknown "
                f"{sorted(set(node) - set(defs))}")
        return {k: build(defs[k], node[k], path + (k,)) for k in defs}

    return ParamTree(build(model_defs(cfg), tree, ()))


def _state_cls(fields):
    from repro_torch.optim.adafactor import AdafactorState
    from repro_torch.optim.adamw import AdamWState
    for cls in (AdamWState, AdafactorState):
        if tuple(fields) == cls._fields:
            return cls
    raise ValueError(f"not an optimizer state: fields {tuple(fields)}")


def opt_state_from_numpy(state, device="cuda"):
    """The port's optimizer state on ``device`` (the card unless the caller
    passes ``"cpu"``; raises without one) from the JAX package's
    (``AdamWState`` or ``AdafactorState`` of numpy arrays, or any
    NamedTuple with their fields).  Each leaf keeps its dtype; ml_dtypes'
    bfloat16 becomes ``torch.bfloat16`` (exactly, through float32)."""
    from repro_torch.tree import tree_map
    device = _device(device)

    def one(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.array(_numpy_leaf(a), copy=True))
        dt = torch.bfloat16 if a.dtype.name == "bfloat16" else t.dtype
        return t.to(device=device, dtype=dt)

    cls = _state_cls(state._fields)
    return cls(*(tree_map(one, getattr(state, f)) for f in cls._fields))


def opt_state_to_numpy(state):
    """The port's optimizer state as the same NamedTuple of numpy arrays
    (bfloat16 leaves widened exactly to float32: numpy has no bfloat16
    without ml_dtypes)."""
    from repro_torch.tree import tree_map

    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return type(state)(*(tree_map(one, v) for v in state))
