"""Core layers (port of ``repro.models.layers``): RMSNorm, rotary
embeddings (RoPE / M-RoPE / sinusoidal), embedding, and gated/plain MLPs.
Pure functions over nested dicts of tensors, with the reference's float32
statistics and casts."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_defs(dim: int, axes=("none",)):
    return {"scale": ParamDef((dim,), axes, init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``rsqrt`` of the mean square in float32, times the scale, cast back
    to ``x``'s dtype (``layers.py:24-30``)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=64)
def _on_device(make, args, device) -> torch.Tensor:
    """``make(*args)`` (a numpy table) as a tensor on ``device``, kept: a
    copy from host memory each call would wait for the card's queue, once
    a layer."""
    return torch.from_numpy(make(*args)).to(device)


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return _on_device(rope_freqs, (head_dim, theta), device)


def _mrope_select(sections) -> np.ndarray:
    return np.concatenate([np.full(s, i) for i, s in enumerate(sections)])


def _sinusoid_freqs(dim: int) -> np.ndarray:
    half = dim // 2
    return 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: [..., S] int.  Rotates halves (not
    interleaved pairs) by float32 angles."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = _freqs(dh, theta, x.device)                       # [half]
    ang = positions[..., None].float() * freqs                # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                        # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections,
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): three position streams (t, h, w) rotate
    disjoint frequency sections of the head dim.

    x: [B, S, H, dh]; positions3: [3, B, S]; sections: half-dim split,
    sum(sections) == dh // 2.
    """
    dh = x.shape[-1]
    half = dh // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = _freqs(dh, theta, x.device)                       # [half]
    # pick, per frequency index, which position stream drives it
    sel = _on_device(_mrope_select, (tuple(sections),), x.device)
    pos_per_freq = positions3[sel]                            # [half,B,S]
    ang = pos_per_freq.permute(1, 2, 0).float() * freqs       # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Classic transformer sinusoidal embedding; positions [..., S] ->
    [..., S, dim] float32."""
    ang = positions[..., None].float() * _on_device(
        _sinusoid_freqs, (dim,), positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_defs(vocab: int, d: int):
    return {"table": ParamDef((vocab, d), ("embed_vocab", "fsdp"),
                              init="embed", scale=1.0)}


def embed(p, tokens: torch.Tensor, *, scale_by_dim: bool = False):
    h = p["table"][tokens]
    if scale_by_dim:
        # a 0-d CPU tensor is a scalar to the card: no copy, no wait
        h = h * torch.tensor(np.sqrt(p["table"].shape[1]), dtype=h.dtype)
    return h


def unembed_defs(d: int, vocab: int):
    return {"kernel": ParamDef((d, vocab), ("fsdp", "embed_vocab"))}


def unembed(p, h: torch.Tensor, *, tied_table=None,
            compute_dtype=torch.float32) -> torch.Tensor:
    """Logits in ``compute_dtype`` (float32)."""
    if tied_table is not None:
        return h.to(compute_dtype) @ tied_table.to(compute_dtype).T
    return h.to(compute_dtype) @ p["kernel"].to(compute_dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s order: ``x * (1 / (1 + exp(-x)))``, each step
    rounded in ``x``'s type, as XLA lowers ``jax.nn.sigmoid`` (``F.silu``
    and ``torch.sigmoid`` round once, which in bfloat16 parts from the
    reference in about a third of the values)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_defs(d: int, ff: int, kind: str = "swiglu"):
    if kind == "swiglu":
        return {
            "wi_gate": ParamDef((d, ff), ("fsdp", "tp")),
            "wi_up": ParamDef((d, ff), ("fsdp", "tp")),
            "wo": ParamDef((ff, d), ("tp", "fsdp")),
        }
    if kind == "gelu":
        return {
            "wi": ParamDef((d, ff), ("fsdp", "tp")),
            "wo": ParamDef((ff, d), ("tp", "fsdp")),
        }
    raise ValueError(kind)


def mlp(p, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
