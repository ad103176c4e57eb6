"""The collective layer of the partitioned mode and of
``compress_batch(mesh=)`` (port of the ``shard_map`` part of
``repro/sharding.py``) on ``torch.distributed``.

A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` with a named
dimension (default ``"data"``): gloo processes on the CPU, NCCL on the
cards.  One partition a rank.  The JAX collectives map as:

* ``jax.lax.axis_index`` / ``mesh.shape[axis]``: :func:`axis_rank`,
  :func:`axis_size` (and :func:`axis_group`, the process group);
* ``ppermute`` of an L-point halo: :func:`halo_from_next` and
  :func:`halo_from_prev`, one ``batch_isend_irecv`` each; a rank with no
  sender gets zeros, as under ``ppermute``;
* ``psum`` of float aggregates: :func:`sum_over_ranks`, an ``all_gather``
  into ``[T, ...]`` summed in rank order by the function the global-array
  form uses for its sum over partitions (``ref.row_sum_xla`` over the
  first axis), so every rank holds the global form's bits.  An
  ``all_reduce`` sums in the backend's own order, which promises neither
  equality across ranks nor equality with the global form; it serves the
  integer counts (:func:`count_over_ranks`).

Run under ``torchrun --nproc_per_node T`` (NCCL, a card a rank) or with
``torch.multiprocessing`` and gloo on the CPU; :func:`mesh_1d` builds the
mesh over the processes of the default group.

The model zoo's expert-parallel MoE (``models/moe_a2a.py``) runs on a 2-D
mesh ``("data", "model")`` (:func:`mesh_2d`) made active for a block of
code with :func:`use_sharding` (read by :func:`active_mesh`), as the
reference's ``use_sharding``/``active_mesh`` (``repro/sharding.py:50-63``);
``all_to_all_single`` over the model dimension's group is its
``all_to_all``.

The model zoo's logical-axis rules (``repro/sharding.py:65-162``) are
here too: :func:`default_rules` maps logical axis names to mesh axes,
:func:`spec_for` gives a dimension's mesh axes under the divisibility
guard (a mesh-axis product that does not divide the dimension is
dropped: replicated), :func:`named_sharding` pairs the spec with its
mesh.  A spec is a :class:`P`, a tuple (``tuple(jax_spec) ==
tuple(port_spec)`` compares the two); a mesh is anything with named axis
sizes, a process-free :class:`AbstractMesh` or a real ``DeviceMesh``, and
the rules read only the sizes, so a 256-card production mesh needs no
process.  Every collective of this module reports itself to
``launch.collectives.record_collectives`` when a recorder is active.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import row_sum_xla
from repro_torch.launch import collectives as _coll

Axes = Union[None, str, tuple]

DEFAULT_AXIS = "data"


def mesh_1d(device_type: str = "cuda", axis: str = DEFAULT_AXIS):
    """A 1-D mesh over every process of the (initialised) default group,
    its one dimension named ``axis``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def mesh_nd(shape, axis_names, device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axis_names`` over every process of the
    default group (row-major: the last axis varies fastest over ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh over "
                         f"{dist.get_world_size()} processes")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_2d(dp: int, mp: int, device_type: str = "cuda"):
    """A ``(dp, mp)`` mesh over the ``dp x mp`` processes of the default
    group, its dimensions named ``("data", "model")``: rank ``r`` sits at
    data index ``r // mp`` and model index ``r % mp``."""
    return mesh_nd((dp, mp), ("data", "model"), device_type)


_state = threading.local()


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` and the logical-axis ``rules`` active in this thread
    for the block (the reference's ``use_sharding``)."""
    prev = (getattr(_state, "mesh", None), getattr(_state, "rules", None))
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def active_mesh():
    """The mesh :func:`use_sharding` made active in this thread, or
    None."""
    return getattr(_state, "mesh", None)


def active_rules() -> Optional[dict]:
    """The rules :func:`use_sharding` made active in this thread, or
    None."""
    return getattr(_state, "rules", None)


# ---------------------------------------------------------------------------
# logical-axis rules (the model zoo's sharding specs)
# ---------------------------------------------------------------------------

def _canonical(part):
    """A spec entry as ``PartitionSpec`` keeps it: a sequence of one axis
    is that axis, an empty one is ``None``."""
    if isinstance(part, (tuple, list)):
        if len(part) == 0:
            return None
        return part[0] if len(part) == 1 else tuple(part)
    return part


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): one entry a
    tensor dimension, ``None`` (replicated), a mesh axis name or a tuple
    of them (the dimension split over their product, the first axis
    major); entries are kept in the reference's canonical form."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self) + ")"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named mesh axis sizes and no devices or processes
    (``jax.sharding.AbstractMesh``): what the rules and the dry-run read
    of a production mesh."""
    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.axis_sizes} and names "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of an :class:`AbstractMesh` or a
    ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_axis_size(mesh, a) for a in axis)
    return mesh_shape(mesh)[axis]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    def __post_init__(self):
        used = [a for part in self.spec if part is not None
                for a in (part if isinstance(part, tuple) else (part,))]
        if len(used) != len(set(used)):
            raise ValueError(f"{self.spec} maps a mesh axis to more than one "
                             f"dimension")

    @property
    def num_devices(self) -> int:
        return math.prod(mesh_shape(self.mesh).values())

    def shard_shape(self, shape) -> tuple:
        """One device's block of a tensor of ``shape``: each dimension
        divided by its axes' product (which must divide it)."""
        parts = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, part in zip(shape, parts):
            n = _axis_size(self.mesh, part)
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} is not "
                                 f"divisible by {part!r} ({n})")
            out.append(dim // n)
        return tuple(out)

    def placements(self) -> tuple:
        """``torch.distributed.tensor`` placements on a ``DeviceMesh``,
        one a mesh dimension: ``Shard(d)`` where the spec puts that axis on
        tensor dimension ``d``, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        where = {}
        for d, part in enumerate(self.spec):
            for a in (part if isinstance(part, (tuple, list)) else (part,)):
                if a is not None:
                    where[a] = d
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in self.mesh.mesh_dim_names)


def default_rules(multi_pod: bool = False, *, fsdp: bool = True,
                  seq_shard: bool = False, expert_axis: str = "model",
                  pod_pipeline: bool = False) -> dict:
    """The reference's baseline rule table
    (``repro/sharding.py:65``): batch over (pod, data), FSDP over data,
    heads / ff / vocab over model, experts over ``expert_axis``, the
    sequence over data with ``seq_shard``, the stage axis over pod with
    ``pod_pipeline``."""
    data_axes = ("pod", "data") if (multi_pod and not pod_pipeline) \
        else ("data",)
    return {
        # activations
        "act_batch": data_axes,
        "act_seq": "data" if seq_shard else None,
        "act_res_seq": "data" if seq_shard else None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_ff": "model",
        "act_vocab": "model",
        "act_kv_seq": "data" if seq_shard else None,
        "act_cache_batch": data_axes,
        "act_cache_seq": None,
        "act_experts": expert_axis,
        "act_inner": "model",
        # parameters
        "fsdp": "data" if fsdp else None,
        "tp": "model",
        "kv_tp": "model",
        "embed_vocab": "model",
        "experts": expert_axis,
        "stage": "pod" if pod_pipeline else None,
        "none": None,
    }


def _resolve(axes: Sequence[Axes], rules: dict) -> list:
    return [None if a is None else rules.get(a, None) for a in axes]


def spec_for(shape: Sequence[int], axes: Sequence[Axes], mesh=None,
             rules: Optional[dict] = None) -> P:
    """The spec of a tensor of ``shape`` with logical ``axes`` under
    ``rules`` on ``mesh`` (the active ones by default), with the
    divisibility guard applied per dimension; ``P()`` without a mesh or
    rules."""
    mesh = mesh if mesh is not None else active_mesh()
    rules = rules if rules is not None else active_rules()
    if mesh is None or rules is None:
        return P()
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in rank")
    parts = []
    for dim, phys in zip(shape, _resolve(axes, rules)):
        n = _axis_size(mesh, phys)
        parts.append(None if phys is None or n <= 1 or dim % n else phys)
    return P(*parts)


def named_sharding(shape, axes, mesh=None, rules=None) -> NamedSharding:
    mesh = mesh if mesh is not None else active_mesh()
    return NamedSharding(mesh, spec_for(shape, axes, mesh, rules))


def constrain(x: torch.Tensor, *axes: Axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes: a
    no-op outside an active mesh and rules.  Under them a ``DTensor`` is
    redistributed to the spec's placements; a plain local tensor comes
    back as it is (eager PyTorch has no constraint on a local tensor:
    its layout is whatever the code that made it chose)."""
    mesh, rules = active_mesh(), active_rules()
    if mesh is None or rules is None or isinstance(mesh, AbstractMesh):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sh = NamedSharding(mesh, spec_for(x.shape, axes, mesh, rules))
    return x.redistribute(mesh, sh.placements())


def axis_group(mesh, axis: str = DEFAULT_AXIS):
    """The process group of the mesh dimension ``axis``."""
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str = DEFAULT_AXIS) -> int:
    """This process's index along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis: str = DEFAULT_AXIS) -> int:
    """The ranks along ``axis`` (``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on: its current card under
    NCCL, the CPU under gloo."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def _shift(send: torch.Tensor, recv_shape, to: int, frm: int, mesh,
           axis: str) -> torch.Tensor:
    """Send ``send`` to the rank at offset ``to`` and receive a tensor of
    ``recv_shape`` from the rank at offset ``frm`` along ``axis`` (zeros
    where that rank does not exist)."""
    group = axis_group(mesh, axis)
    r, T = axis_rank(mesh, axis), axis_size(mesh, axis)
    recv = torch.zeros(recv_shape, dtype=send.dtype, device=send.device)
    ops = []
    if 0 <= r + to < T:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, r + to), group))
    if 0 <= r + frm < T:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, r + frm), group))
    if _coll.RECORDER is not None:
        _coll.note("collective-permute", recv.numel() * recv.element_size(),
                   T, "sharding._shift")
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def halo_from_next(t: torch.Tensor, width: int, mesh,
                   axis: str = DEFAULT_AXIS) -> torch.Tensor:
    """The next rank's ``t[..., :width]`` (zeros on the last rank): a
    right halo, ``ppermute`` with pairs ``(i, i - 1)``."""
    head = t[..., :width]
    return _shift(head, head.shape, -1, 1, mesh, axis)


def halo_from_prev(t: torch.Tensor, width: int, mesh,
                   axis: str = DEFAULT_AXIS) -> torch.Tensor:
    """The previous rank's ``t[..., -width:]`` (zeros on rank 0): a left
    halo, ``ppermute`` with pairs ``(i, i + 1)``."""
    tail = t[..., t.shape[-1] - width:]
    return _shift(tail, tail.shape, 1, -1, mesh, axis)


def gather_ranks(x: torch.Tensor, mesh,
                 axis: str = DEFAULT_AXIS) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``[T, ...]``, on every
    rank (bool tensors travel as uint8)."""
    T = axis_size(mesh, axis)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(T)]
    if _coll.RECORDER is not None:
        _coll.note("all-gather", T * src.numel() * src.element_size(), T,
                   "sharding.gather_ranks")
    dist.all_gather(parts, src, group=axis_group(mesh, axis))
    out = torch.stack(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def sum_over_ranks(x: torch.Tensor, mesh,
                   axis: str = DEFAULT_AXIS) -> torch.Tensor:
    """``psum`` of a float tensor: every rank's ``x`` gathered in rank
    order and summed as the global form sums its partitions
    (:func:`sum_partitions`), the same bits on every rank."""
    return sum_partitions(gather_ranks(x, mesh, axis))


def sum_partitions(parts: torch.Tensor) -> torch.Tensor:
    """``parts.sum(0)`` in the order of the reference's
    ``jax.tree.map(lambda a: a.sum(0), contribs)`` (XLA's row-reduce over
    the partitions: a chain from +0 up to 32 of them)."""
    return row_sum_xla(torch.movedim(parts, 0, -1))


def count_over_ranks(x: torch.Tensor, mesh,
                     axis: str = DEFAULT_AXIS) -> torch.Tensor:
    """``psum`` of an integer tensor (exact in any order)."""
    x = x.clone()
    if _coll.RECORDER is not None:
        _coll.note("all-reduce", x.numel() * x.element_size(),
                   axis_size(mesh, axis), "sharding.count_over_ranks")
    dist.all_reduce(x, group=axis_group(mesh, axis))
    return x
