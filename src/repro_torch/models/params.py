"""Parameter definition trees (port of ``repro.models.params``): one
declaration site for shape, dtype, logical axes and initializer.

A model builds a nested dict of :class:`ParamDef`; from it come the real
parameters (``init_params``: a :class:`ParamTree` module, one seeded draw
per tree path), the dry-run's stand-ins (``abstract_params``: a
:class:`TensorSpec` a leaf, its sharding from the logical ``axes`` under
``sharding.spec_for``; ``.meta()`` gives an empty tensor on the meta
device, nothing is drawn), the specs alone (``param_specs``,
``param_shardings``) and the parameter count (``count_params``, shape
arithmetic only).

The reference folds ``hash(path_element)`` into its key
(``src/repro/models/params.py:53``); a ``str`` hash is salted per process,
so its weights differ between processes.  The port seeds each leaf from
``zlib.crc32`` of its dotted path instead, and draws on the CPU, so the
same seed gives the same weights in every process and on every device.
The draws are torch's, not ``jax.random``'s: carry the reference's weights
across with ``convert.params_from_numpy``.

``init_params(..., draw="device")`` draws each leaf on the device it is
asked for instead, from a generator on that device seeded by the same
``path_seed``: the same weights in every process on that kind of device,
but not the CPU draw's (the card's generator is another), and tens of
times faster for a model of billions of parameters.  A comparison of the
card against the CPU keeps the CPU draw and carries its weights over.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Optional, Tuple

import torch
from torch import nn

from repro_torch import sharding as shd
from repro_torch.core.cameo import _device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Any, ...]                 # logical axes, len == len(shape)
    dtype: torch.dtype = torch.float32
    init: str = "linear"                  # linear | embed | zeros | ones
    fan_axis: int = 0                     # fan-in dim for "linear"
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")


def _is_def(x):
    return isinstance(x, ParamDef)


def _map_defs(fn, defs, path=()):
    if _is_def(defs):
        return fn(path, defs)
    return {k: _map_defs(fn, v, path + (k,)) for k, v in defs.items()}


def path_seed(seed: int, path) -> int:
    """The draw's seed of the leaf at ``path``: ``zlib.crc32`` of the seed
    and the dotted path (stable across processes, unlike ``hash``).  It is
    32 bits wide because torch's CPU generator keeps only a seed's low 32
    bits: a seed placed above them would be dropped."""
    return zlib.crc32(f"{int(seed)}/{'.'.join(path)}".encode())


def _draw(path, d: ParamDef, seed: int, device=None) -> torch.Tensor:
    """One leaf's float32 values by the reference's rules, drawn on
    ``device`` (default the CPU) from a generator there."""
    device = torch.device("cpu") if device is None else device
    if d.init == "zeros":
        return torch.zeros(d.shape, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, device=device)
    gen = torch.Generator(device=device).manual_seed(path_seed(seed, path))
    x = torch.randn(d.shape, generator=gen, device=device)
    if d.init == "embed":
        return x.mul_(d.scale)
    if d.init != "linear":
        raise ValueError(f"unknown init {d.init!r}")
    return x.mul_(d.scale / math.sqrt(max(d.shape[d.fan_axis], 1)))


class ParamTree(nn.Module):
    """A parameter tree as modules: every dict of the definition tree is a
    submodule, every leaf a (frozen) ``nn.Parameter``, so ``state_dict()``
    keys are the reference's tree paths joined by ``.``
    (``blocks.sub0.attn.q``)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for k, v in tensors.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        """The nested dict of tensors the model functions read."""
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def as_tree(params) -> dict:
    """``params`` as a nested dict of tensors (a :class:`ParamTree` or
    already a dict)."""
    return params.tree() if isinstance(params, ParamTree) else params


def init_params(defs, seed: int = 0, device="cuda", param_dtype=None,
                draw: str = "cpu") -> ParamTree:
    """Materialize parameters on ``device`` (the card unless the caller
    passes ``"cpu"``; raises without one) in ``param_dtype`` (default each
    def's dtype): normal x scale / sqrt(fan_in) ("linear"), normal x scale
    ("embed"), zeros or ones, each leaf drawn in float32 from its own
    generator (:func:`path_seed`) and then cast and moved.  ``draw="cpu"``
    (the default) draws on the CPU, the same weights on every device;
    ``draw="device"`` draws on ``device`` (other values than the CPU's on
    the card, much faster there)."""
    if draw not in ("cpu", "device"):
        raise ValueError(f"draw is 'cpu' or 'device', got {draw!r}")
    device = _device(device)
    on = device if draw == "device" else None

    def one(path, d: ParamDef):
        dtype = param_dtype or d.dtype
        return _draw(path, d, seed, on).to(device=device, dtype=dtype)

    return ParamTree(_map_defs(one, defs))


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape, dtype and sharding, nothing allocated
    (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[shd.NamedSharding] = None

    def meta(self) -> torch.Tensor:
        """An empty tensor of this shape and dtype on the meta device."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def abstract_params(defs, mesh=None, rules=None, param_dtype=None):
    """A :class:`TensorSpec` tree with ``NamedSharding``s: the dry-run's
    stand-ins."""

    def one(path, d: ParamDef):
        dtype = param_dtype or d.dtype
        if mesh is not None:
            s = shd.named_sharding(d.shape, d.axes, mesh, rules)
            return TensorSpec(d.shape, dtype, s)
        return TensorSpec(d.shape, dtype)

    return _map_defs(one, defs)


def param_shardings(defs, mesh=None, rules=None):
    def one(path, d: ParamDef):
        return shd.named_sharding(d.shape, d.axes, mesh, rules)

    return _map_defs(one, defs)


def param_specs(defs, mesh=None, rules=None):
    def one(path, d: ParamDef):
        return shd.spec_for(d.shape, d.axes, mesh, rules)

    return _map_defs(one, defs)


def count_params(defs) -> int:
    total = 0

    def one(path, d: ParamDef):
        nonlocal total
        total += math.prod(d.shape)
        return None

    _map_defs(one, defs)
    return total


def stack_defs(defs, n: int, axis_name=None):
    """Add a leading layer axis of size n to every def (the stacked block
    parameters)."""

    def one(path, d: ParamDef):
        return ParamDef(shape=(n,) + d.shape, axes=(axis_name,) + d.axes,
                        dtype=d.dtype, init=d.init,
                        fan_axis=d.fan_axis + 1, scale=d.scale)

    return _map_defs(one, defs)
