"""Explicit data-parallel train step with gradient compression (error
feedback) applied before the cross-replica mean (port of
``repro.train.dp_shardmap``).

The reference runs the step under ``shard_map`` on a ``data`` mesh axis.
The port runs it on ``torch.distributed``, one process a rank: each rank
holds the replicated parameters, the optimizer state and its own
error-feedback residuals, and its rows of the batch (the reference's
``P(axis)``: rank ``r`` of ``W`` takes rows ``r*B/W`` to ``(r+1)*B/W``,
:func:`shard_batch`).  A step:

1. ``loss_fn``'s gradients of the local rows (``train.step``);
2. ``optim.compress.compress_with_feedback`` on them, leaf by leaf: the
   sent leaf in float32 and the new residual, written into the residual
   tree in place;
3. the mean of the sent leaves and the loss over the ``axis`` group: one
   ``all_reduce`` (SUM) of a bucket, then the reference's division by
   ``W`` (``pmean`` is ``psum`` over ``psum(1)``).  Small leaves share a
   bucket of up to ``BUCKET`` elements (the loss rides in the last one);
   a larger leaf is reduced alone, in place.  Not ``sharding.sum_over_ranks``'
   gather, which would hold ``W`` copies of every gradient.  A ring or
   tree all-reduce reduces each chunk once and broadcasts the result, so
   every rank gets the same bits and the replicas stay equal; the sum's
   order is the backend's, not XLA's;
4. ``adamw_update`` at the constant ``tcfg.peak_lr`` (the reference reads
   no schedule and no step here).

It returns ``(params, opt_state, residuals, {"loss": mean over ranks,
"grad_norm"})``, the first three updated in place.  NCCL on the cards,
gloo on the CPU, and nothing else: the step raises if the group's backend
does not match the parameters' device.  Run it under ``torchrun
--nproc_per_node W`` (NCCL, a card a rank) or with
``torch.multiprocessing`` and gloo on the CPU; ``sharding.mesh_1d`` builds
the mesh.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives as _coll
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.compress import CompressConfig, compress_with_feedback
from repro_torch.train.step import TrainConfig, _grads
from repro_torch.tree import leaves, unflatten

# elements a shared all-reduce bucket holds (256 MiB of float32)
BUCKET = 1 << 26


def check_backend(backend: str, device: torch.device) -> None:
    """Refuse a group whose backend does not serve ``device``: NCCL for a
    card's tensors, gloo for the CPU's."""
    want = "nccl" if device.type == "cuda" else "gloo"
    if str(backend).lower() != want:
        raise ValueError(f"the data-parallel step needs a {want} group for "
                         f"tensors on {device}, got {backend!r}")


def shard_batch(batch: dict, mesh, axis: str = "data") -> dict:
    """This rank's rows of a global batch (``P(axis)``): rank ``r`` of
    ``W`` takes rows ``r*B/W`` to ``(r+1)*B/W``."""
    r, W = shd.axis_rank(mesh, axis), shd.axis_size(mesh, axis)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % W:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows over {W} "
                             f"ranks")
        n = v.shape[0] // W
        out[k] = v[r * n:(r + 1) * n]
    return out


def _all_reduce_mean(bucket: list, group, W: int) -> None:
    """Sum the tensors of ``bucket`` over ``group`` in one ``all_reduce``
    and divide by ``W``, in place."""
    if len(bucket) == 1:
        flat = bucket[0]
    else:
        flat = torch.cat([t.reshape(-1) for t in bucket])
    if _coll.RECORDER is not None:
        _coll.note("all-reduce", flat.numel() * flat.element_size(), W,
                   "dp_shardmap.step")
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(W)
    if len(bucket) > 1:
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view(t.shape))


def build_dp_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                        ccfg: CompressConfig, axis: str = "data") -> Callable:
    """The step over ``mesh``'s ``axis`` (a ``DeviceMesh`` over the default
    group): ``step(params, opt_state, residuals, batch, step=None)`` with
    this rank's rows in ``batch``."""
    group = shd.axis_group(mesh, axis)
    W = shd.axis_size(mesh, axis)
    backend = dist.get_backend(group)

    @torch.no_grad()
    def dp_step(params, opt_state, residuals, batch, step=None):
        glist = leaves(params)
        check_backend(backend, glist[0].device)
        _, loss, _, grads = _grads(params, cfg, tcfg, batch, None)
        glist = leaves(grads)
        del grads
        rlist = leaves(residuals)
        sent, bucket, n = [], [], 0
        for i, r in enumerate(rlist):
            s, r_new = compress_with_feedback(glist[i], r, ccfg)
            glist[i] = None                  # free the gradient leaf
            r.copy_(r_new)
            del r_new
            sent.append(s)
            if s.numel() >= BUCKET:
                _all_reduce_mean([s], group, W)
                continue
            if n + s.numel() > BUCKET:
                _all_reduce_mean(bucket, group, W)
                bucket, n = [], 0
            bucket.append(s)
            n += s.numel()
        mean_loss = loss.float().reshape(1).clone()
        _all_reduce_mean(bucket + [mean_loss], group, W)
        lr = torch.tensor(tcfg.peak_lr, dtype=torch.float32)
        params, opt_state, gnorm = adamw_update(
            unflatten(params, sent), opt_state, params, lr, tcfg.adamw)
        return params, opt_state, residuals, {"loss": mean_loss[0],
                                              "grad_norm": gnorm}

    return dp_step
