"""Composable decoder model over block patterns (port of
``repro.models.model``): dense / windowed attention and Mamba2 mixers, each
with a dense or MoE MLP (or none), in any pattern (the hybrid's too).

* ``model_defs``   — ParamDef tree (stacked block params).
* ``forward``      — train-time logits + the summed MoE aux loss.
* ``prefill``      — last-position logits + per-layer caches for serving
                     (``KVCache`` for attention, ``MambaCache`` for Mamba).
* ``decode_step``  — one-token step against the stacked caches.
* ``cache_specs``  — the caches' shapes, dtypes and shardings, nothing
                     allocated (the dry-run's stand-ins).

The reference scans the repeated block pattern (``jax.lax.scan`` over the
stacked block params); the port walks the block axis in a Python loop.
Serving reads block ``i``'s parameters and caches as views ``[i]``.
``forward`` with grad enabled takes each stacked leaf apart once
(``torch.unbind``, whose backward is one ``stack``; a ``[i]`` view's
backward writes a zero tensor the size of the whole stacked leaf, once a
block) and applies ``cfg.remat`` to each block as the reference's
``_remat_wrap`` does: ``full`` recomputes the block in the backward pass
(``torch.utils.checkpoint``), ``dots`` saves the projections' 2-D
products and recomputes the rest.  The reference's ``constrain`` calls
are not made: on the local tensors of one card ``sharding.constrain`` is a
no-op (the MoE's a2a forms shard over ranks under
``sharding.use_sharding``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import sharding as shd
from repro_torch.configs.base import LayerSpec, ModelConfig, layer_ctx
from repro_torch.core.cameo import _device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import moe_a2a
from repro_torch.models.layers import (
    embed, embed_defs, mlp, mlp_defs, rmsnorm, rmsnorm_defs,
    sinusoidal_positions, unembed, unembed_defs,
)
from repro_torch.models.params import TensorSpec, as_tree, stack_defs


# ---------------------------------------------------------------------------
# definitions
# ---------------------------------------------------------------------------

def layer_defs(cfg: ModelConfig, ls: LayerSpec):
    d = {"pre_norm": rmsnorm_defs(cfg.d_model)}
    if ls.kind == "attn":
        d["attn"] = attn.attention_defs(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias)
    elif ls.kind == "mamba":
        d["mamba"] = mb.mamba_defs(layer_ctx(cfg, ls))
    else:
        raise ValueError(ls.kind)
    if cfg.sandwich_norm:
        d["post_mix_norm"] = rmsnorm_defs(cfg.d_model)
    if ls.moe or ls.mlp:
        d["mlp_norm"] = rmsnorm_defs(cfg.d_model)
        if ls.moe:
            d["moe"] = moe_mod.moe_defs(
                cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                cfg.n_shared_experts)
        else:
            d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind)
        if cfg.sandwich_norm:
            d["post_mlp_norm"] = rmsnorm_defs(cfg.d_model)
    return d


def model_defs(cfg: ModelConfig):
    block = {f"sub{j}": layer_defs(cfg, ls)
             for j, ls in enumerate(cfg.pattern)}
    defs = {
        "embed": embed_defs(cfg.vocab, cfg.d_model),
        "blocks": stack_defs(block, cfg.n_blocks),
        "final_norm": rmsnorm_defs(cfg.d_model),
    }
    for j, ls in enumerate(cfg.remainder):
        defs[f"rem{j}"] = layer_defs(cfg, ls)
    if not cfg.tie_embeddings:
        defs["lm_head"] = unembed_defs(cfg.d_model, cfg.vocab)
    return defs


def _index(tree, i: int):
    """Block ``i``'s slice of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (attn.KVCache, mb.MambaCache)):
        return type(tree)(*(_index(a, i) for a in tree))
    return tree[i]


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _mlp_half(cfg, ls, ctx, p, h):
    """The MLP half of a layer (dense, MoE through ``moe_a2a.moe_apply`` by
    ``cfg.moe_impl``, or none).  Returns (h, the MoE aux loss or None)."""
    aux = None
    if not (ls.moe or ls.mlp):
        return h, aux
    u = rmsnorm(p["mlp_norm"], h, cfg.norm_eps)
    if ls.moe:
        y, aux = moe_a2a.moe_apply(p["moe"], u, ctx, impl=cfg.moe_impl)
    else:
        y = mlp(p["mlp"], u, kind=cfg.mlp_kind)
    if cfg.sandwich_norm:
        y = rmsnorm(p["post_mlp_norm"], y, cfg.norm_eps)
    return h + y, aux


def _apply_layer_full(cfg, ls, p, h, positions, want_cache: bool,
                      max_len: Optional[int] = None):
    """Full-sequence layer (train/prefill). Returns (h, aux|None,
    cache|None)."""
    ctx = layer_ctx(cfg, ls)
    u = rmsnorm(p["pre_norm"], h, cfg.norm_eps)
    cache = None
    if ls.kind == "attn":
        mix, (k, v) = attn.attend_train(p["attn"], u, positions, ctx)
        if want_cache:
            pos2 = positions if positions.dim() == 2 else positions[0]
            cache = _kv_cache_from_prefill(ctx, k, v, pos2, cfg, max_len)
    else:
        mix, mcache = mb.mamba_train(p["mamba"], u, ctx)
        if want_cache:
            cache = mcache
    if cfg.sandwich_norm:
        mix = rmsnorm(p["post_mix_norm"], mix, cfg.norm_eps)
    h, aux = _mlp_half(cfg, ls, ctx, p, h + mix)
    return h, aux, cache


def _kv_cache_from_prefill(ctx, k, v, positions, cfg, max_len=None):
    """Place prefill K/V (already rotated) into a ring cache of the layer's
    cache size (capacity ``max_len``), slotting position p at p % size."""
    B, S = positions.shape
    size = attn.kv_cache_size(ctx, max_len or S)
    dev = k.device
    if size >= S:
        pad = size - S
        kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pc = torch.nn.functional.pad(positions.to(torch.int32), (0, pad),
                                     value=-1)
    else:
        # windowed/pruned layer: keep the last `size` tokens, ring-placed
        k_tail = k[:, S - size:]
        v_tail = v[:, S - size:]
        pos_tail = positions[:, S - size:].to(torch.int32)
        slots = torch.remainder(pos_tail, size).long()        # [B, size]
        bidx = torch.arange(B, device=dev)[:, None].expand(B, size)
        kc = torch.zeros_like(k_tail)
        vc = torch.zeros_like(v_tail)
        pc = torch.full((B, size), -1, dtype=torch.int32, device=dev)
        kc[bidx, slots] = k_tail
        vc[bidx, slots] = v_tail
        pc[bidx, slots] = pos_tail
    if attn._quantized(ctx):
        kq, ks = attn._quantize_kv(kc)
        vq, vs = attn._quantize_kv(vc)
        return attn.KVCache(k=kq, v=vq, pos_ids=pc, k_scale=ks, v_scale=vs)
    one = torch.ones((1,), device=dev)
    return attn.KVCache(k=kc, v=vc, pos_ids=pc, k_scale=one, v_scale=one)


def _apply_layer_decode(cfg, ls, p, h, pos: int, cache):
    ctx = layer_ctx(cfg, ls)
    u = rmsnorm(p["pre_norm"], h, cfg.norm_eps)
    if ls.kind == "attn":
        mix, cache = attn.attend_decode(p["attn"], u, pos, cache, ctx)
    else:
        mix, cache = mb.mamba_decode(p["mamba"], u, cache, ctx)
    if cfg.sandwich_norm:
        mix = rmsnorm(p["post_mix_norm"], mix, cfg.norm_eps)
    return _mlp_half(cfg, ls, ctx, p, h + mix)[0], cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, batch):
    """Token (and stub frontend) embeddings in the activation dtype, and
    the positions: ``batch["positions"]`` or ``arange(S)`` ([3, B, S] for
    mrope)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    h = embed(params["embed"], tokens, scale_by_dim=cfg.scale_embed)
    h = h.to(cfg.adtype())
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(cfg.adtype())      # [B, n_patches, d]
        h = torch.cat([pe, h[:, pe.shape[1]:, :]], dim=1)
    positions = batch.get("positions")
    if positions is None:
        base = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        positions = base[None].expand(3, B, S) if cfg.pos == "mrope" else base
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    return h, positions


def _head(cfg, params, h):
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    return unembed(params.get("lm_head"), h, tied_table=tied)


def _unbound(tree, n: int) -> list:
    """The ``n`` blocks' trees of a stacked tree, each leaf taken apart
    once with ``torch.unbind`` (views; one ``stack`` in the backward)."""
    if isinstance(tree, dict):
        parts = {k: _unbound(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _block_body(cfg, positions, h, aux, block):
    """One block of the pattern: (h, aux) with each MoE layer's aux loss
    added in layer order, as the reference's scan carry adds it."""
    for j, ls in enumerate(cfg.pattern):
        h, a, _ = _apply_layer_full(cfg, ls, block[f"sub{j}"], h, positions,
                                    want_cache=False)
        if a is not None:       # the reference adds 0 for a dense layer
            aux = aux + a
    return h, aux


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable`` for torch: keep the outputs of
    the 2-D products (``mm``, ``addmm``, and a ``bmm`` over a batch of one,
    which is how ``einsum`` runs a projection), recompute the rest."""
    if op in _MM or (op == torch.ops.aten.bmm.default
                     and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg, fn):
    """``fn`` under ``cfg.remat`` (none | full | dots), as the reference's
    ``_remat_wrap`` wraps its scan body."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(cfg.remat)


def _layers(cfg, params):
    """(layer spec, its parameters, cache key, block index or None) of every
    layer in order: the blocks' pattern for each block, then the
    remainder."""
    for i in range(cfg.n_blocks):
        block = _index(params["blocks"], i)
        for j, ls in enumerate(cfg.pattern):
            yield ls, block[f"sub{j}"], f"sub{j}", i
    for j, ls in enumerate(cfg.remainder):
        yield ls, params[f"rem{j}"], f"rem{j}", None


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch, *, unbind=None):
    """Training forward: logits [B, S, V] f32 + scalar aux loss.

    With grad enabled the blocks run under ``cfg.remat``, and each stacked
    leaf is taken apart once (``unbind``, default: when grad is enabled);
    ``unbind=False`` reads block ``i`` as the views ``[i]`` instead (the
    same values; the serving form)."""
    params = as_tree(params)
    grad = torch.is_grad_enabled()
    unbind = grad if unbind is None else unbind
    h, positions = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    body = functools.partial(_block_body, cfg, positions)
    if grad:
        body = _remat_wrap(cfg, body)
    blocks = _unbound(params["blocks"], cfg.n_blocks) if unbind else None
    for i in range(cfg.n_blocks):
        block = blocks[i] if unbind else _index(params["blocks"], i)
        h, aux = body(h, aux, block)
    for j, ls in enumerate(cfg.remainder):
        h, a, _ = _apply_layer_full(cfg, ls, params[f"rem{j}"], h, positions,
                                    want_cache=False)
        if a is not None:
            aux = aux + a
    return _head(cfg, params, h), aux


def _stack_caches(caches: list):
    """Layer caches (all ``KVCache`` or all ``MambaCache``) stacked on a
    leading block axis."""
    return type(caches[0])(*(torch.stack(f) for f in zip(*caches)))


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_len: Optional[int] = None):
    """Prefill: last-position logits + caches (the blocks' stacked
    ``[n_blocks, ...]`` under ``"blocks"``, the remainder's per layer).

    ``max_len`` sets cache capacity for subsequent decode steps."""
    params = as_tree(params)
    h, positions = _embed_inputs(cfg, params, batch)
    per_block = {f"sub{j}": [] for j in range(len(cfg.pattern))}
    caches = {}
    for ls, p, key, i in _layers(cfg, params):
        h, _, c = _apply_layer_full(cfg, ls, p, h, positions,
                                    want_cache=True, max_len=max_len)
        if i is None:
            caches[key] = c
        else:
            per_block[key].append(c)
    caches = {"blocks": {k: _stack_caches(v) for k, v in per_block.items()},
              **caches}
    return _head(cfg, params, h[:, -1:, :]), caches


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                pos: int):
    """One decode step: token [B, 1] int, ``pos`` a Python int.

    Returns (logits [B, 1, V], caches), the caches updated in place."""
    params = as_tree(params)
    h = embed(params["embed"], token, scale_by_dim=cfg.scale_embed)
    h = h.to(cfg.adtype())
    if cfg.pos == "sinusoidal":
        p1 = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                        device=token.device)
        h = h + sinusoidal_positions(p1, cfg.d_model).to(h.dtype)
    for ls, p, key, i in _layers(cfg, params):
        c = caches[key] if i is None else _index(caches["blocks"][key], i)
        h, _ = _apply_layer_decode(cfg, ls, p, h, pos, c)
    return _head(cfg, params, h), caches


# ---------------------------------------------------------------------------
# cache initialization / dry-run specs
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, B: int, max_len: int, dtype=None,
                device="cuda"):
    """Empty caches on ``device`` (the card unless the caller passes
    ``"cpu"``; raises without one)."""
    dtype = dtype or cfg.adtype()
    device = _device(device)

    def one(ls: LayerSpec):
        ctx = layer_ctx(cfg, ls)
        if ls.kind == "attn":
            return attn.init_kv_cache(ctx, B, max_len, dtype, device)
        return mb.init_mamba_cache(ctx, B, dtype, device)

    caches = {"blocks": {f"sub{j}": _stack_caches([one(ls)] * cfg.n_blocks)
                         for j, ls in enumerate(cfg.pattern)}}
    for j, ls in enumerate(cfg.remainder):
        caches[f"rem{j}"] = one(ls)
    return caches


def cache_specs(cfg: ModelConfig, B: int, max_len: int, mesh, rules,
                dtype=None):
    """The caches' ``TensorSpec``s with their shardings (the dry-run's
    decode stand-ins): the blocks' stacked on a leading replicated block
    axis, the remainder's per layer."""
    dtype = dtype or cfg.adtype()

    def one(ls: LayerSpec):
        ctx = layer_ctx(cfg, ls)
        if ls.kind == "attn":
            return attn.kv_cache_specs(ctx, B, max_len, dtype, mesh, rules)
        return mb.mamba_cache_specs(ctx, B, dtype, mesh, rules)

    def stack(c):
        return type(c)(*(TensorSpec((cfg.n_blocks,) + s.shape, s.dtype,
                                    _stacked_sharding(s, mesh)) for s in c))

    caches = {"blocks": {f"sub{j}": stack(one(ls))
                         for j, ls in enumerate(cfg.pattern)}}
    for j, ls in enumerate(cfg.remainder):
        caches[f"rem{j}"] = one(ls)
    return caches


def _stacked_sharding(s: TensorSpec, mesh) -> shd.NamedSharding:
    spec = s.sharding.spec if s.sharding is not None else shd.P()
    return shd.NamedSharding(mesh, shd.P(*((None,) + tuple(spec))))
