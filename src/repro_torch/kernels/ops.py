"""Impact-engine backend: one dispatch point for the impact and aggregate
math of the rounds mode (port of ``repro/kernels/ops.py``).

Backends, chosen per call and plumbed from ``CameoConfig.backend``:

* ``"cuda"``      — the hand-written kernels (``lag_dot``, ``acf_impact``,
  ``fused_round.window_rows_cuda``).  Asking for it with CPU tensors raises.
* ``"reference"`` — the plain PyTorch forms, on whatever device the
  tensors lie.
* ``"auto"``      — the kernels for card tensors, the plain forms for CPU
  tensors.  ``CAMEO_BACKEND=cuda|reference`` overrides how ``"auto"``
  resolves; explicit choices are never overridden.

The kernels serve ``stat="acf"`` with the measures ``mae | rmse | cheb``
reduced in-kernel.  Other configurations compute the rows in plain torch
whatever the backend, as the JAX package does.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.lag_dot import lag_dot_cuda, lag_dot_plain

BACKENDS = ("auto", "cuda", "reference")


def resolve_backend(backend: str = "auto", device=None) -> str:
    """Resolve ``"auto"`` to a concrete backend for tensors on ``device``
    (``None``: this process's default card if it has one), honouring
    ``CAMEO_BACKEND``.  ``"cuda"`` for a CPU device raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    if backend == "auto":
        env = os.environ.get("CAMEO_BACKEND", "").strip()
        if not env:
            return "cuda" if on_card else "reference"
        if env not in ("cuda", "reference"):
            raise ValueError(f"CAMEO_BACKEND={env!r} not in "
                             f"('cuda', 'reference')")
        backend = env
    if backend == "cuda" and not on_card:
        raise ValueError("backend='cuda' runs the CUDA kernels and needs "
                         f"tensors on the card, got device {device}")
    return backend


# an ``Aggregates`` five-tuple as the kernels' [5, L] table
agg_to_table = _ref.as_table


def _transform_fn(stat: str):
    if stat == "acf":
        return lambda r: r
    if stat == "pacf":
        from repro_torch.core.acf import pacf_from_acf  # deferred: core imports ops
        return pacf_from_acf
    raise ValueError(f"unknown stat {stat!r}")


def _kernel_eligible(backend: str, stat: str, measure: str,
                     device=None) -> bool:
    return (resolve_backend(backend, device) == "cuda" and stat == "acf"
            and measure in _ref.KERNEL_MEASURES)


# ---------------------------------------------------------------------------
# Eq. 7 — lagged products
# ---------------------------------------------------------------------------

def lag_dot(a: torch.Tensor, L: int, *, b=None, halo=None,
            backend: str = "auto") -> torch.Tensor:
    """``out[l-1] = sum_{t<m} a_t * b_ext_{t+l}`` for l=1..L, shape [L].

    Defaults (``b=None, halo=None``) give the Eq. 7 self-products ``sxx``;
    ``b`` computes cross lagged products and ``halo`` appends an L-point
    continuation of ``b`` past the chunk end.
    """
    if resolve_backend(backend, a.device) == "cuda":
        return lag_dot_cuda(a, b, halo, L=L)
    return lag_dot_plain(a, b, halo, L=L)


# ---------------------------------------------------------------------------
# Eq. 9 — x-space delta windows onto the target series
# ---------------------------------------------------------------------------

def x_window_to_y(cfg, dwin: torch.Tensor, start: torch.Tensor):
    """Map x-space delta windows onto the target (aggregate) series.

    ``dwin`` is ``[..., W]`` with matching ``start [...]``; for
    ``kappa == 1`` this is the identity, otherwise each window is
    segment-summed onto the ``Wy = W // kappa + 2`` covered y cells.  The
    segment sum is a one-hot reduction, deterministic on every device
    (a scatter-add would sum in atomic order on the card).
    """
    kap = cfg.kappa
    if kap == 1:
        return dwin, start
    W = dwin.shape[-1]
    Wy = W // kap + 2
    b0 = start // kap
    j = torch.arange(W, dtype=torch.int32, device=dwin.device)
    seg = (start[..., None] + j) // kap - b0[..., None]          # [..., W]
    cells = torch.arange(Wy, dtype=seg.dtype, device=dwin.device)
    onehot = (seg[..., None] == cells).to(dwin.dtype)             # [..., W, Wy]
    dyw = torch.sum(dwin[..., None] * onehot, dim=-2)
    return _ref.div_exact(dyw, kap), b0
