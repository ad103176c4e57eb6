"""Expert-parallel MoE with explicit all-to-all dispatch (port of
``repro.models.moe_a2a``) on ``torch.distributed``.

Per rank: route -> bucket the (token, choice) pairs by destination model
rank -> ``all_to_all_single`` over the mesh's ``model`` group -> local
capacity dispatch -> expert FFN on the rank's resident experts -> reverse
``all_to_all_single`` -> weighted combine at the source.

The reference runs the body under ``shard_map`` with the global ``x`` in and
the global ``y`` out.  The port takes the global ``x`` on every rank; each
rank cuts its block as the reference's ``in_specs`` do (its rows along the
data axes, its sequence split along ``model`` where the length divides, its
``E / mp`` experts, and for ``a2a2d`` its ``ff`` slice along ``data``), and
the result is the global ``y`` on every rank (``out_specs``): the blocks
are all-gathered in rank order.  The ``pmean`` of the aux loss and
``a2a2d``'s ``psum`` over the ff shard sum in rank order
(``sharding.sum_over_ranks``), so every rank holds the same bits.  The
scatters write only kept entries, whose slots are unique
(``moe.scatter_kept``).

Chosen per config by ``ModelConfig.moe_impl``; :func:`moe_apply` falls
back to the scatter path where the reference does: no active mesh
(``sharding.use_sharding``), a model axis of 1, or E not divisible by it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.kernels.ref import div_exact
from repro_torch.launch import collectives as _coll
from repro_torch.models import moe as moe_base
from repro_torch.models.layers import mlp

_Q8_GROUP = 128


def _positions_by_dest(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """dest: [n] destination ids.  Returns the slot [n] (int32) each entry
    takes in its destination's send bucket, in sequence order (overflow at
    or past the bucket's capacity)."""
    oh = F.one_hot(dest.long(), n_dest).to(torch.int32)           # [n, D]
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh         # exclusive
    return torch.gather(pos, 1, dest.long()[:, None])[:, 0]


def _q8(t: torch.Tensor):
    """Per-128-group int8 quantization of an a2a payload: (int8 values,
    float32 per-group scales ``[..., g, 1]``)."""
    shape = t.shape
    g = shape[-1] // _Q8_GROUP
    tg = t.float().reshape(shape[:-1] + (g, _Q8_GROUP))
    s = torch.clamp(torch.amax(torch.abs(tg), dim=-1, keepdim=True),
                    min=1e-8) / 127.0
    q = torch.clamp(torch.round(tg / s), -127, 127)
    return q.to(torch.int8).reshape(shape), s


def _dq8(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    shape = q.shape
    g = shape[-1] // _Q8_GROUP
    qg = q.float().reshape(shape[:-1] + (g, _Q8_GROUP))
    return (qg * s).reshape(shape).to(dtype)


def _a2a(send: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(send, axis, 0, 0, tiled=False)``: block ``i`` of
    the leading axis goes to rank ``i`` of ``group``, and block ``i`` of the
    result came from rank ``i``."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    if _coll.RECORDER is not None:
        _coll.note("all-to-all", send.numel() * send.element_size(),
                   dist.get_world_size(group), "moe_a2a._a2a")
    dist.all_to_all_single(recv, send, group=group)
    return recv


def _dispatch(xt, eidx, mp: int, e_loc: int, cf: float, group, quantize):
    """Route ``xt [t, d]``'s choices ``eidx [t, k]`` to the model ranks and
    bucket what arrives by local expert.  Returns (buf [e_loc, C2, d], the
    receive side's (local expert, slot, kept), the send side's source
    index [mp, cs] (+1; 0 empty), cs)."""
    t, d = xt.shape
    k = eidx.shape[1]
    n = t * k
    eflat = eidx.reshape(n)
    dest = eflat // e_loc                                        # model rank
    cs = int(math.ceil(t * k / mp * cf / 8.0) * 8)               # send cap
    slot = _positions_by_dest(dest, mp)
    keep = slot < cs
    src = torch.arange(n, device=xt.device)
    send_x = moe_base.scatter_kept((mp, cs, d), (dest, slot), keep, cs,
                           xt[src // k])
    # metadata: local expert id (+1; 0 = empty), source flat index (+1)
    send_e = moe_base.scatter_kept((mp, cs), (dest, slot), keep, cs,
                           (eflat % e_loc + 1).to(torch.int32))
    send_s = moe_base.scatter_kept((mp, cs), (dest, slot), keep, cs,
                           (src + 1).to(torch.int32))
    if quantize:
        sq, ss = _q8(send_x)
        recv_x = _dq8(_a2a(sq, group), _a2a(ss, group), xt.dtype)
    else:
        recv_x = _a2a(send_x, group)
    recv_e = _a2a(send_e, group)

    # local dispatch into the resident expert shard
    rx = recv_x.reshape(mp * cs, d)
    re = recv_e.reshape(mp * cs)
    valid = re > 0
    le = torch.where(valid, re - 1, 0).long()
    C2 = int(math.ceil(mp * cs / e_loc * cf / 8.0) * 8)
    pos2 = _positions_by_dest(torch.where(valid, le, e_loc), e_loc + 1)
    keep2 = valid & (pos2 < C2)
    pos2c = torch.clamp(pos2, max=C2 - 1).long()
    buf = moe_base.scatter_kept((e_loc, C2, d), (le, pos2), keep2, C2, rx)
    return buf, (le, pos2c, keep2), send_s, cs


def _combine(out, recv, send_s, cs: int, w, group):
    """Expert outputs ``out [e_loc, C2, d]`` back to their sources: gather
    to the receive slots, reverse all-to-all, place at the source entries,
    combine with the weights ``w [t, k]`` (in the outputs' type)."""
    le, pos2c, keep2 = recv
    mp = send_s.shape[0]
    t, k = w.shape
    d = out.shape[-1]
    n = t * k
    y_slots = torch.where(keep2[:, None], out[le, pos2c],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device)).reshape(mp, cs, d)
    back = _a2a(y_slots, group)
    flat_src = send_s.reshape(mp * cs).long() - 1               # -1: empty
    y_tok = torch.zeros((n + 1, d), dtype=out.dtype, device=out.device)
    y_tok[torch.where(flat_src >= 0, flat_src, n)] = back.reshape(mp * cs, d)
    return torch.einsum("tkd,tk->td", y_tok[:n].reshape(t, k, d),
                        w.to(out.dtype))


def _data_index(mesh, axis: str):
    """(index, size) of this rank along every mesh dimension but ``axis``,
    flattened in the mesh's order (the reference's ``data_axes``)."""
    idx, size = 0, 1
    for a in mesh.mesh_dim_names:
        if a != axis:
            n = shd.axis_size(mesh, a)
            idx, size = idx * n + shd.axis_rank(mesh, a), size * n
    return idx, size


def _gather_blocks(y: torch.Tensor, mesh, axis: str, seq_split: bool):
    """Every rank's block ``[B_loc, S_loc, d]`` assembled into the global
    ``[B, S, d]`` on every rank: the model ranks' sequence blocks (or, when
    the sequence was not split, their equal copies: the first), then the
    data ranks' rows."""
    ym = shd.gather_ranks(y, mesh, axis)                  # [mp, B_loc, S, d]
    y = torch.cat(list(ym), dim=1) if seq_split else ym[0]
    for a in reversed([a for a in mesh.mesh_dim_names if a != axis]):
        y = torch.cat(list(shd.gather_ranks(y, mesh, a)), dim=0)
    return y


def moe_apply_a2a(p, x: torch.Tensor, spec, mesh, axis: str = "model",
                  quantize: bool = False):
    """x: [B, S, d], the same global tensor on every rank.  Returns (y, aux),
    the global results on every rank.

    The sequence axis is split over ``model`` on entry whenever divisible,
    so each model rank routes 1/mp of its data row's tokens.
    ``quantize=True`` sends int8 payloads with float32 per-group scales
    through the dispatch all-to-all; the return path stays in the
    activations' type (``moe_a2a.py:74-82``)."""
    mp = shd.axis_size(mesh, axis)
    mi = shd.axis_rank(mesh, axis)
    group = shd.axis_group(mesh, axis)
    E, k, cf = spec.n_experts, spec.top_k, spec.capacity_factor
    e_loc = E // mp
    B, S, d = x.shape
    di, dp = _data_index(mesh, axis)
    if B % dp:
        raise ValueError(f"batch {B} does not divide over {dp} data ranks")
    b_loc = B // dp
    seq_split = S % mp == 0 and S >= mp
    xb = x[di * b_loc:(di + 1) * b_loc]
    if seq_split:
        xb = xb[:, mi * (S // mp):(mi + 1) * (S // mp)]
    ex = slice(mi * e_loc, (mi + 1) * e_loc)

    B_loc, S_loc, _ = xb.shape
    t = B_loc * S_loc
    xt = xb.reshape(t, d)
    logits, probs, w, eidx = moe_base.route(p, xt, k)             # [t, k]
    buf, recv, send_s, cs = _dispatch(xt, eidx, mp, e_loc, cf, group,
                                      quantize)
    out = moe_base.expert_ffn(buf, p["wi_gate"][ex], p["wi_up"][ex],
                              p["wo"][ex])
    y = _combine(out, recv, send_s, cs, w, group).reshape(B_loc, S_loc, d)

    # aux: the block's estimate, averaged over model then the data axes
    aux = moe_base.aux_loss(logits, probs, eidx[:, 0], spec)
    aux = div_exact(shd.sum_over_ranks(aux, mesh, axis), mp)
    for a in mesh.mesh_dim_names:
        if a != axis:
            aux = div_exact(shd.sum_over_ranks(aux, mesh, a),
                            shd.axis_size(mesh, a))
    y = _gather_blocks(y, mesh, axis, seq_split)
    if "shared" in p:
        y = y + mlp(p["shared"], x, kind="swiglu")
    return y, aux


def moe_apply_a2a_2d(p, x: torch.Tensor, spec, mesh, axis: str = "model",
                     ff_axis: str = "data"):
    """Weight-resident serving variant: experts sharded over ``model`` and
    their ff dim over ``ff_axis``; the tokens replicated on every rank, so
    the partial ff contributions sum over ``ff_axis`` (a ``psum`` of the
    expert outputs, in rank order).  Every rank computes the global y;
    aux is 0 (``moe_a2a.py:165-247``)."""
    mp = shd.axis_size(mesh, axis)
    mi = shd.axis_rank(mesh, axis)
    group = shd.axis_group(mesh, axis)
    E, k, cf = spec.n_experts, spec.top_k, spec.capacity_factor
    e_loc = E // mp
    B, S, d = x.shape
    fp = shd.axis_size(mesh, ff_axis)
    fi = shd.axis_rank(mesh, ff_axis)
    ff = p["wi_gate"].shape[-1]
    if ff % fp:
        raise ValueError(f"ff {ff} does not divide over {fp} ranks")
    fs = slice(fi * (ff // fp), (fi + 1) * (ff // fp))
    ex = slice(mi * e_loc, (mi + 1) * e_loc)

    t = B * S
    xt = x.reshape(t, d)
    _, _, w, eidx = moe_base.route(p, xt, k)
    buf, recv, send_s, cs = _dispatch(xt, eidx, mp, e_loc, cf, group, False)
    out = moe_base.expert_ffn(buf, p["wi_gate"][ex][..., fs],
                              p["wi_up"][ex][..., fs], p["wo"][ex][:, fs])
    out = shd.sum_over_ranks(out, mesh, ff_axis)
    y = _combine(out, recv, send_s, cs, w, group).reshape(B, S, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x, kind="swiglu")
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def moe_apply(p, x: torch.Tensor, spec, impl: str = "scatter"):
    """Dispatching wrapper: the a2a forms when asked for and a model axis
    of more than one rank is active and divides the experts; otherwise the
    scatter path (``models/moe.py``).  The a2a forms need live ranks: under
    a process-free ``sharding.AbstractMesh`` (the dry-run's) they raise."""
    mesh = shd.active_mesh()
    if impl != "scatter" and isinstance(mesh, shd.AbstractMesh):
        raise ValueError(f"moe_impl {impl!r} needs a DeviceMesh of live "
                         f"ranks, not an AbstractMesh")
    mp = shd.mesh_shape(mesh).get("model", 1) if mesh is not None else 1
    usable = mp > 1 and spec.n_experts % mp == 0
    if impl == "a2a" and usable:
        return moe_apply_a2a(p, x, spec, mesh)
    if impl == "a2a_q8" and usable:
        return moe_apply_a2a(p, x, spec, mesh, quantize=True)
    if impl == "a2a2d" and usable:
        return moe_apply_a2a_2d(p, x, spec, mesh)
    return moe_base.moe_apply(p, x, spec)
