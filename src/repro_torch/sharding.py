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
``all_to_all``.  The model-zoo rules of the JAX file (``default_rules``,
``spec_for``, ``named_sharding``) are not ported (ROADMAP A4.3).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import row_sum_xla

DEFAULT_AXIS = "data"


def mesh_1d(device_type: str = "cuda", axis: str = DEFAULT_AXIS):
    """A 1-D mesh over every process of the (initialised) default group,
    its one dimension named ``axis``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def mesh_2d(dp: int, mp: int, device_type: str = "cuda"):
    """A ``(dp, mp)`` mesh over the ``dp x mp`` processes of the default
    group, its dimensions named ``("data", "model")``: rank ``r`` sits at
    data index ``r // mp`` and model index ``r % mp``."""
    from torch.distributed.device_mesh import init_device_mesh
    if dp * mp != dist.get_world_size():
        raise ValueError(f"a {dp} x {mp} mesh over "
                         f"{dist.get_world_size()} processes")
    return init_device_mesh(device_type, (dp, mp),
                            mesh_dim_names=("data", "model"))


_state = threading.local()


@contextlib.contextmanager
def use_sharding(mesh):
    """Make ``mesh`` active in this thread for the block (the reference's
    ``use_sharding`` without its rule table, which the port does not
    read)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def active_mesh():
    """The mesh :func:`use_sharding` made active in this thread, or
    None."""
    return getattr(_state, "mesh", None)


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
    dist.all_reduce(x, group=axis_group(mesh, axis))
    return x
