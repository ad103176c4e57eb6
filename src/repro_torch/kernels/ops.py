"""Impact-engine backend: one dispatch point for the impact and aggregate
math of the compressor (port of ``repro/kernels/ops.py``): Eq. 7 lagged
products, Algorithm-2 single-delta impacts (Eq. 8), exact windowed impacts
(Eq. 9) and the GetAllImpact ranking of both modes.

Backends, chosen per call and plumbed from ``CameoConfig.backend``:

* ``"cuda"``      — the hand-written kernels (``lag_dot``, ``prefix_sum``,
  ``dense_sxx``, ``segment_cells``, ``acf_impact``, ``acf_window_impact``,
  ``fused_round.window_rows_cuda`` and ``fused_round.prefix_devs_cuda``).
  Asking for it with CPU tensors raises.  Every path's Eq. 9 delta windows
  come from :func:`segment_cells` (its kernel on the card);
  :func:`x_window_to_y` and ``core.aggregates.segment_deltas`` are the
  pair it replaces, kept as its plain version (and ``cell_sum`` as
  ``x_window_to_y``'s kernel, which no path launches).
* ``"reference"`` — the plain PyTorch forms, on whatever device the
  tensors lie.
* ``"auto"``      — the kernels for card tensors, the plain forms for CPU
  tensors.  ``CAMEO_BACKEND=cuda|reference`` overrides how ``"auto"``
  resolves; explicit choices are never overridden.

The kernels serve ``stat="acf"`` with the measures ``mae | rmse | cheb``
reduced in-kernel.  Other configurations compute the rows in plain torch
whatever the backend, as the JAX package does.  Where a kernel serves a
configuration, the plain path computes the kernel's plain version (fixed
summation order), so the CPU and the card rank alike.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.core import measures as _measures
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.acf_impact import acf_impact_cuda
from repro_torch.kernels.acf_window_impact import acf_window_impact_cuda
from repro_torch.kernels.cell_sum import cell_sum_cuda, cell_sum_plain
from repro_torch.kernels.dense_sxx import dense_sxx_cuda, dense_sxx_plain
from repro_torch.kernels.lag_dot import lag_dot_cuda, lag_dot_plain
from repro_torch.kernels.prefix_sum import prefix_sum_cuda, prefix_sum_plain
from repro_torch.kernels.segment_cells import (segment_cells_cuda,
                                               segment_cells_plain)

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


def dense_sxx(y_old: torch.Tensor, delta: torch.Tensor, ny, L: int,
              backend: str = "auto") -> torch.Tensor:
    """The dense update's bilinear term ``[..., L]`` in the reference's CPU
    order (``kernels/dense_sxx.py``; the kernel on the card, the plain
    version on the CPU: the same bits)."""
    if resolve_backend(backend, y_old.device) == "cuda":
        return dense_sxx_cuda(y_old, delta, ny, L)
    return dense_sxx_plain(y_old, delta, ny, L)


def prefix_sum(x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Inclusive prefix sums of ``x [..., n]`` over the last axis in XLA's
    cumsum order (``kernels/prefix_sum.py``; the kernel on the card, the
    plain version on the CPU: the JAX reference's bits, whatever the rows
    beside a row)."""
    if resolve_backend(backend, x.device) == "cuda":
        return prefix_sum_cuda(x)
    return prefix_sum_plain(x)


# ---------------------------------------------------------------------------
# Eq. 8 — single-delta impacts (Algorithm 2)
# ---------------------------------------------------------------------------

def acf_impact(y, dval, agg, p0, *, measure: str = "mae", block: int = 1024,
               backend: str = "auto"):
    """Algorithm-2 impacts for all points: D(ACF_after_delta_i, P0), ``[n]``
    for a delta ``dval[i]`` at ``y[i]``.  The ``acf_impact`` kernel where
    it serves (card tensors, mae/rmse/cheb; ``acf_impact_cuda``), else
    ``ref.acf_impact_ref``.  ``block`` is the TPU kernel's tile and is
    accepted for the reference's signature; the port's kernel picks its
    own."""
    table = agg_to_table(agg)
    L = p0.shape[-1]
    if _kernel_eligible(backend, "acf", measure, y.device):
        return acf_impact_cuda(y, dval, table.contiguous(), p0, L=L,
                               measure=measure)
    return _ref.acf_impact_ref(y, dval, table, p0, L=L, measure=measure)


# ---------------------------------------------------------------------------
# Eq. 9 — windowed impacts
# ---------------------------------------------------------------------------

def window_impact(y, dwins, starts, agg, p0, *, measure: str = "mae",
                  backend: str = "auto"):
    """Exact Eq. 9 impacts ``[P]`` for P candidate windows against ``y``:
    ``dwins [P, W]`` are zero-padded delta windows starting at the absolute
    indices ``starts [P]``."""
    table = agg_to_table(agg)
    L = p0.shape[0]
    ny = y.shape[0]
    rows_ctx = _ref.candidate_contexts(y, starts, L=L, W=dwins.shape[1])
    if resolve_backend(backend, y.device) == "cuda":
        return acf_window_impact_cuda(
            rows_ctx.contiguous(), dwins.contiguous(),
            starts.to(torch.int32).contiguous(), table.contiguous(), p0,
            ny=ny, L=L, measure=measure)
    return _ref.acf_window_impact_ref(rows_ctx, dwins, starts, table, p0,
                                      ny=ny, measure=measure)


# ---------------------------------------------------------------------------
# ranking engine — GetAllImpact for the compressor
# ---------------------------------------------------------------------------

def _measure_transform(cfg):
    return _measures.get_measure(cfg.measure), _transform_fn(cfg.stat)


def _rows_dev(cfg, rows, p0):
    """Deviation of ``[P, L]`` ACF rows from ``p0``: the kernels' fixed-order
    reduction where a kernel serves the configuration, else the measure
    over the transformed rows."""
    if cfg.stat == "acf" and cfg.measure in _ref.KERNEL_MEASURES:
        return _ref.measure_rows(rows, p0, cfg.measure)
    mfn, transform = _measure_transform(cfg)
    return mfn(transform(rows), p0)


def _single_impacts_kernel(cfg, table, y, dval, p0):
    """Kernel-path Eq. 8 impacts for all n x-candidates (the port's kernel
    takes the ``i // kappa`` map itself, so every kappa is one launch)."""
    return acf_impact_cuda(y, dval, table.contiguous(), p0, L=cfg.lags,
                           measure=cfg.measure, kappa=cfg.kappa)


def _single_impacts_ref(cfg, agg, y, y_idx, dval, p0, n: int):
    """Plain-path Eq. 8 impacts, chunked as the JAX package chunks them."""
    chunk = min(cfg.impact_chunk, n)
    out = []
    for c in range(0, n, chunk):
        rows = _ref.acf_after_single_delta(agg, y, y_idx[c:c + chunk],
                                           dval[c:c + chunk])
        out.append(_rows_dev(cfg, rows, p0))
    return torch.cat(out)


def _rank_single(cfg, agg, y, xr, alive, p0, n: int):
    """Algorithm-2 (single-delta) ranking impact for all n points."""
    from repro_torch.core.aggregates import alive_neighbors, interpolate_at
    dt = cfg.tdtype()
    idx = torch.arange(n, dtype=torch.int32, device=xr.device)
    prev, nxt = alive_neighbors(alive)
    dx = interpolate_at(xr, prev, nxt, idx) - xr
    if cfg.kappa == 1:
        y_idx, dval = idx, dx
    else:
        y_idx = idx // cfg.kappa
        dval = _ref.div_exact(dx, cfg.kappa)
    if _kernel_eligible(cfg.backend, cfg.stat, cfg.measure, xr.device):
        imp = _single_impacts_kernel(cfg, agg_to_table(agg), y, dval, p0)
    else:
        imp = _single_impacts_ref(cfg, agg, y, y_idx, dval, p0, n)
    removable = alive & (idx > 0) & (idx < n - 1)
    return torch.where(removable, imp.to(dt), float("inf"))


def _window_rows_impact(cfg, table, rows, dyw, starts, p0, ny: int,
                        use_kernel: bool):
    """Eq. 9 impacts ``[P]`` of the delta windows ``dyw [P, Wy]`` against
    their context rows ``rows [P, Wy + 2L]`` (global ``starts [P]``): one
    ``acf_window_impact`` launch, or its plain version."""
    if use_kernel:
        return acf_window_impact_cuda(
            rows.contiguous(), dyw.contiguous(), starts.to(torch.int32),
            table.contiguous(), p0, ny=ny, L=cfg.lags, measure=cfg.measure)
    return _rows_dev(cfg, _ref.acf_after_window_delta_rows(
        table, rows, starts, dyw, ny=ny), p0)


def _rank_window(cfg, agg, y_ctx, xr_c, alive_c, p0, off_y, ny: int):
    """Exact windowed (Eq. 9) ranking impact for every candidate of T
    partitions (T = 1: a whole series): ``y_ctx [T, my + 2L + W]`` are the
    haloed target contexts (``y_ctx[t, k] = y_t[k - L]``, zeros out of
    range), ``xr_c`` and ``alive_c [T, mx]``, ``off_y [T]`` the global y
    offsets.  Each impact chunk's candidates of every partition are one
    batch of context rows, so on the card a chunk is one
    ``acf_window_impact`` launch whatever T is (rows are independent, and
    the table, ``p0`` and ``ny`` are global).  Returns ``(impact,
    overgrown)``, ``[T, mx]`` each: candidates whose segment outgrew the
    static window ``W`` keep their truncated-window value here."""
    from repro_torch.core.aggregates import alive_neighbors
    dt = cfg.tdtype()
    L, W = cfg.lags, cfg.window
    T, mx = xr_c.shape
    dev = xr_c.device
    idx = torch.arange(mx, dtype=torch.int32, device=dev)
    prev, nxt = alive_neighbors(alive_c)
    use_kernel = _kernel_eligible(cfg.backend, cfg.stat, cfg.measure, dev)
    offs = torch.as_tensor(off_y, device=dev).reshape(T, 1)
    table = agg_to_table(agg)
    chunk = min(cfg.impact_chunk, mx)
    imps, spans = [], []
    for c in range(0, mx, chunk):
        ci = idx[c:c + chunk].expand(T, -1)
        dyw, ystart, span = segment_cells(cfg, xr_c, prev, nxt, ci,
                                          W)                # [T, k, Wy]
        Wy = dyw.shape[-1]
        k = torch.arange(Wy + 2 * L, device=dev)
        rows = _ref.take(y_ctx, ystart[..., None] + k).reshape(-1, Wy + 2 * L)
        imp = _window_rows_impact(cfg, table, rows, dyw.reshape(-1, Wy),
                                  (offs + ystart).reshape(-1), p0, ny,
                                  use_kernel)
        imps.append(imp.reshape(T, -1).to(dt))
        spans.append(span)
    removable = alive_c & (idx > 0) & (idx < mx - 1)
    imp = torch.where(removable, torch.cat(imps, -1), float("inf"))
    return imp, torch.cat(spans, -1) > W


def ranking_impact(cfg, agg, y, xr, alive, p0, n: int, *, rank=None):
    """GetAllImpact: ranking impact for every point of a whole series, by
    ``rank`` (default ``cfg.rank``): ``"single"`` the Algorithm-2 Eq. 8
    approximation, ``"window"`` the exact Eq. 9 segment form with the
    single-delta estimate for overgrown segments."""
    rank = cfg.rank if rank is None else rank
    if rank == "single":
        return _rank_single(cfg, agg, y, xr, alive, p0, n)
    if rank != "window":
        raise ValueError(f"unknown rank {rank!r}")
    L, W = cfg.lags, cfg.window
    y_ctx = F.pad(y, (L, L + W))
    imp, overgrown = _rank_window(cfg, agg, y_ctx[None], xr[None],
                                  alive[None], p0, 0, y.shape[0])
    imp_sd = _rank_single(cfg, agg, y, xr, alive, p0, n)
    return torch.where(overgrown[0], imp_sd, imp[0]).to(cfg.tdtype())


def chunk_ranking_impact(cfg, agg, y_ctx, xr_c, alive_c, p0, off_y, ny: int):
    """Partitioned-mode ranking: exact windowed impacts for one partition's
    candidates (``y_ctx [my + 2L + W]``, ``xr_c`` and ``alive_c [mx]``),
    or for T partitions with a leading axis (one launch an impact chunk
    for all T, see :func:`_rank_window`).  Overgrown segments rank +inf."""
    if xr_c.dim() == 1:
        return chunk_ranking_impact(cfg, agg, y_ctx[None], xr_c[None],
                                    alive_c[None], p0, off_y, ny)[0]
    imp, overgrown = _rank_window(cfg, agg, y_ctx, xr_c, alive_c, p0, off_y,
                                  ny)
    return torch.where(overgrown, float("inf"), imp)


def window_impact_at(cfg, agg, y, xr, prev, nxt, cand, p0):
    """Exact (Eq. 9) ranking impact of removing each point in ``cand`` (the
    sequential mode's ReHeap).  Overgrown segments and the series
    endpoints rank +inf."""
    n = xr.shape[0]
    L, W = cfg.lags, cfg.window
    dyw, ystart, span = segment_cells(cfg, xr, prev, nxt, cand, W)
    k = torch.arange(dyw.shape[1] + 2 * L, device=y.device)
    rows = F.pad(y, (L, L + W))[ystart[:, None] + k]
    imp = _window_rows_impact(
        cfg, agg_to_table(agg), rows, dyw, ystart, p0, y.shape[0],
        _kernel_eligible(cfg.backend, cfg.stat, cfg.measure, xr.device))
    interior = (cand > 0) & (cand < n - 1)
    return torch.where((span <= W) & interior, imp.to(cfg.tdtype()),
                       float("inf"))


# ---------------------------------------------------------------------------
# Eq. 9 — x-space delta windows onto the target series
# ---------------------------------------------------------------------------

def segment_cells(cfg, xr: torch.Tensor, prev: torch.Tensor,
                  nxt: torch.Tensor, i, W: int, *, x_window: bool = False):
    """The Eq. 9 delta windows of removing the candidates ``i`` on the
    target series: ``(dyw [..., Wy], ystart [...], span [...])``, what
    ``x_window_to_y(cfg, *segment_deltas(xr, prev, nxt, i, W)[:2])`` and
    the span give (``kernels/segment_cells.py``: one launch of its kernel
    on the card, the pair itself on the CPU, the same bits);
    ``x_window=True`` appends the x-space window and its start."""
    if resolve_backend(getattr(cfg, "backend", "auto"), xr.device) == "cuda":
        return segment_cells_cuda(xr, prev, nxt, i, W, cfg.kappa, x_window)
    return segment_cells_plain(xr, prev, nxt, i, W, cfg.kappa, x_window)


def x_window_to_y(cfg, dwin: torch.Tensor, start: torch.Tensor):
    """Map x-space delta windows onto the target (aggregate) series.

    ``dwin`` is ``[..., W]`` with matching ``start [...]``; for
    ``kappa == 1`` this is the identity, otherwise each window is
    segment-summed onto the ``Wy = W // kappa + 2`` covered y cells, each
    cell left to right from +0 and divided by kappa once, as strict XLA
    runs the reference's ``segment_sum`` (``kernels/cell_sum.py``: the
    kernel on the card, the plain version on the CPU, the same bits).
    No path calls it: :func:`segment_cells` computes the windows and their
    cells in one launch on the card, and its plain version is this map
    after ``core.aggregates.segment_deltas``.
    """
    kap = cfg.kappa
    if kap == 1:
        return dwin, start
    if resolve_backend(getattr(cfg, "backend", "auto"),
                       dwin.device) == "cuda":
        dyw = cell_sum_cuda(dwin, start, kap)
    else:
        dyw = cell_sum_plain(dwin, start, kap)
    return dyw, start // kap
