"""Fused round kernels of the rounds mode (port of
``repro/kernels/fused_round.py``): the Eq. 9 tier rows and the
prefix-feasibility scan of ``select="scan"``.

Window rows.  Each rounds-mode tier ranks up to ``cap`` multi-point
segments exactly: one hypothetical ACF row per candidate delta window,
applied alone.  The plain form (:func:`window_acf_rows` over
:func:`_moment_deltas`) relies on the padded-bucket discipline — ``y`` is
zero beyond ``ny`` and before 0, and deltas only touch valid positions —
so the head/tail masks are contiguous cuts of the window axis and the
bilinear term needs none.  ``window_rows_cuda`` gives what the rounds
mode's tier ranking reads: each row reduced to its deviation from ``p0``.
It launches ``csrc/window_rows.cu`` for card tensors and computes its plain
version, ``ref.measure_rows`` over :func:`window_acf_rows`, for CPU tensors.

Prefix scan.  A scan round walks its K rank-ordered candidates once with
the running reconstruction ``z``: per candidate the trial deviation of
applying it on top of what was committed, then a commit — always
(``greedy=False``: the prefix deviation curve) or only where the trial fits
``eps`` (``greedy=True``).  ``prefix_devs_cuda`` launches
``csrc/prefix_devs.cu`` for card tensors and computes its plain version,
:func:`prefix_devs_plain` (the same exact walk), for CPU tensors.  The
reference forms (:func:`prefix_acf_rows_ref`, the scan in
:func:`greedy_feasible`) assume every earlier ``ok`` candidate applied, as
the JAX package's do.

Lanes.  Both kernels take a batch of series on a leading lane axis (``y
[B, nyb]``, ``dyws [B, K, Wy]``, ``ystarts``/``ok [B, K]``, table ``[B, 5,
L]``, ``p0 [B, L]``, ``ny``/``eps [B]`` → ``[B, K]``): one launch for every
lane (``window_rows``: a grid row a lane; ``prefix_devs``: a block a lane),
each lane's output the bits of its launch alone, as ``vmap`` over the TPU
kernels gives them a batch grid axis.  The plain versions take the lane axis
too (``window_rows`` with it broadcast, ``prefix_devs`` lane by lane).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.acf_impact import MEASURE_CODE
from repro_torch.kernels.prefix_sum import prefix_sum_plain
from repro_torch.kernels.ref import lane_col, take


def _cumsum_xla(x, dim: int = -1):
    """Inclusive prefix sums over ``dim`` in XLA's cumsum order (a blocked
    scan of base 16 in ``x``'s type, ``prefix_sum.prefix_sum_plain``): the
    order of the reference's ``jnp.cumsum`` along either axis of a
    ``[K, Wy]``, ``[K, nyb + Wy]`` or ``[K, 5, L]`` array."""
    x = torch.movedim(x, dim, -1).contiguous()
    return torch.movedim(prefix_sum_plain(x), -1, dim)


def _prefix_xla(x):
    """``[K, W + 1]`` exclusive prefix sums of ``x [K, W]``: the
    reference's ``pad(jnp.cumsum(x, axis=1), ((0, 0), (1, 0)))``."""
    return F.pad(_cumsum_xla(x), (1, 0))


def _head_tail_sums(d, e, ystarts, ny, L):
    K, Wy = d.shape
    l = torch.arange(1, L + 1, device=d.device)
    # head keeps abs_t <= ny-1-l  <=>  j < ny - l - s   (contiguous prefix);
    # tail keeps abs_t >= l       <=>  j >= l - s       (contiguous suffix).
    cdz = _prefix_xla(d)
    cez = _prefix_xla(e)
    c_head = torch.clamp(ny - l[None, :] - ystarts[:, None], 0, Wy).long()
    c_tail = torch.clamp(l[None, :] - ystarts[:, None], 0, Wy).long()
    dsx = torch.gather(cdz, 1, c_head)
    dsx2 = torch.gather(cez, 1, c_head)
    dsxl = cdz[:, -1:] - torch.gather(cdz, 1, c_tail)
    dsxl2 = cez[:, -1:] - torch.gather(cez, 1, c_tail)
    return dsx, dsxl, dsx2, dsxl2


def _moment_deltas(d, ctx, ystarts, ny, *, L: int):
    """Five per-lag aggregate deltas ``[K, 5, L]`` for independent windowed
    deltas ``d [K, Wy]`` given their series context ``ctx [K, Wy + 2L]``
    (``ctx[k, i] = y[start_k - L + i]``).

    The head and tail sums gather XLA's cumsum order (:func:`_prefix_xla`).
    The bilinear term reads the lag-shifted context through shift views
    (``unfold``) for all lags at once and sums over the window in XLA's
    row-reduce order (``ref.row_sum_xla``), the order of the reference's
    roll form ``jnp.sum(d * g, axis=1)``.
    """
    K, Wy = d.shape
    e = d * (2.0 * ctx[:, L:L + Wy] + d)
    dsx, dsxl, dsx2, dsxl2 = _head_tail_sums(d, e, ystarts, ny, L)
    win = ctx.unfold(1, Wy, 1)                      # [K, 2L+1, Wy]: ctx[s:s+Wy]
    fwd = win[:, L + 1:]                            # s = L + l
    bwd = win[:, :L].flip(1)                        # s = L - l
    d_f = F.pad(d, (0, L)).unfold(1, Wy, 1)[:, 1:]  # d[j + l], zero past Wy
    G = (fwd + bwd) + d_f                           # [K, L, Wy]
    dsxx = _ref.row_sum_xla(d[:, None, :] * G)
    return torch.stack([dsx, dsxl, dsx2, dsxl2, dsxx], dim=1)  # [K, 5, L]


def _moment_deltas_ref(d, ctx, ystarts, ny, *, L: int):
    """Loop oracle for :func:`_moment_deltas`: the L-unrolled
    slice-multiply-sum form of the bilinear term."""
    K, Wy = d.shape
    e = d * (2.0 * ctx[:, L:L + Wy] + d)
    dsx, dsxl, dsx2, dsxl2 = _head_tail_sums(d, e, ystarts, ny, L)
    d_pad = F.pad(d, (0, L))
    dsxx = torch.stack(
        [_ref.row_sum_xla(d * (ctx[:, L + lag:L + lag + Wy]
                               + ctx[:, L - lag:L - lag + Wy]
                               + d_pad[:, lag:lag + Wy]))
         for lag in range(1, L + 1)], dim=1)
    return torch.stack([dsx, dsxl, dsx2, dsxl2, dsxx], dim=1)  # [K, 5, L]


def candidate_context(y, ystarts, *, L: int, Wy: int):
    """Per-candidate ``[..., K, Wy + 2L]`` context of the zero-padded ``y``
    at the start clipped into ``[0, nyb)``, zeros out of range."""
    nyb = y.shape[-1]
    starts = torch.clamp(ystarts, 0, nyb - 1)
    kk = torch.arange(Wy + 2 * L, device=y.device)
    return take(F.pad(y, (L, L + Wy)), starts[..., None] + kk)


def solo_moment_rows(y, dyws, ystarts, ny, *, L: int):
    """Aggregate-delta rows ``[..., K, 5, L]`` for each candidate applied
    alone on the current reconstruction (context gathered from ``y``
    only); lanes are taken as more candidates, each with its lane's
    ``ny``."""
    Wy = dyws.shape[-1]
    ctx = candidate_context(y, ystarts, L=L, Wy=Wy)
    d = dyws.to(y.dtype)
    if y.dim() == 1:
        return _moment_deltas(d, ctx, ystarts, ny, L=L)
    B, K = ystarts.shape
    ny_k = torch.as_tensor(lane_col(ny, ystarts), device=y.device)
    rows = _moment_deltas(d.reshape(B * K, Wy), ctx.reshape(B * K, -1),
                          ystarts.reshape(B * K),
                          ny_k.expand(B, K).reshape(B * K, 1), L=L)
    return rows.reshape(B, K, 5, L)


def window_acf_rows(y, dyws, ystarts, agg_table, ny, *, L: int):
    """Independent per-candidate Eq. 9 ACF rows ``[..., K, L]`` (the plain
    version of the ``window_rows`` kernel)."""
    dt = y.dtype
    cum = solo_moment_rows(y, dyws, ystarts, ny, L=L) \
        + agg_table.unsqueeze(-3)
    l = torch.arange(1, L + 1, device=y.device)
    m = (lane_col(ny, ystarts[..., None]) - l).to(dt)
    return _ref.acf_from_table(cum, m)


def window_rows_plain(y, dyws, ystarts, agg_table, ny, p0, *, L: int,
                      measure: str):
    """Plain version of the ``window_rows`` kernel: the rows' deviations
    from ``p0`` ``[..., K]`` (``ref.measure_rows`` over
    :func:`window_acf_rows`)."""
    rows = window_acf_rows(y, dyws, ystarts, agg_table, ny, L=L)
    return _ref.measure_rows(rows, p0, measure)


def window_rows_cuda(y, dyws, ystarts, agg_table, ny, p0, *, L: int,
                     measure: str):
    """Eq. 9 ranking impacts ``[K]`` (``[B, K]`` for lanes): each
    candidate's ACF row reduced to its deviation from ``p0`` under
    ``measure`` (mae/rmse/cheb).  The CUDA kernel for card tensors, the
    plain version for CPU tensors.

    On the card every operand is float32 (``ystarts`` int32) and ``ny``
    int32 device values, one a lane, so the launch needs no host sync.
    """
    if y.device.type != "cuda":
        return window_rows_plain(y, dyws, ystarts, agg_table, ny, p0, L=L,
                                 measure=measure)
    dev = y.device
    if measure not in MEASURE_CODE:
        raise ValueError(f"window_rows reduces mae/rmse/cheb, got {measure!r}")
    for name, t in (("y", y), ("dyws", dyws), ("table", agg_table),
                    ("p0", p0)):
        if not (isinstance(t, torch.Tensor) and t.device == dev
                and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError(f"window_rows: {name} must be a contiguous "
                             f"float32 tensor on {dev}")
    for name, t in (("ystarts", ystarts), ("ny", ny)):
        if not (isinstance(t, torch.Tensor) and t.device == dev
                and t.dtype == torch.int32 and t.is_contiguous()):
            raise ValueError(f"window_rows: {name} must be a contiguous "
                             f"int32 tensor on {dev}")
    lead = tuple(y.shape[:-1])
    B = lead[0] if lead else 1
    K, Wy = dyws.shape[-2:]
    if (y.dim() not in (1, 2) or B < 1 or tuple(dyws.shape) != lead + (K, Wy)
            or tuple(ystarts.shape) != lead + (K,) or ny.numel() != B
            or tuple(agg_table.shape) != lead + (5, L) or Wy < 1
            or tuple(p0.shape) != lead + (L,)):
        raise ValueError(
            f"window_rows: shapes y {tuple(y.shape)}, dyws {tuple(dyws.shape)}"
            f", ystarts {tuple(ystarts.shape)}, table {tuple(agg_table.shape)}"
            f", p0 {tuple(p0.shape)}, ny {tuple(ny.shape)} do not fit L={L}")
    out = torch.empty(lead + (K,), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    fn = _build.bind("window_rows", "window_rows_f32", 7, 6)
    _build.check(fn(dyws.data_ptr(), ystarts.data_ptr(), y.data_ptr(),
                    agg_table.data_ptr(), ny.data_ptr(), p0.data_ptr(),
                    out.data_ptr(), K, Wy, y.shape[-1], L,
                    MEASURE_CODE[measure], B,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "window_rows")
    window_rows_cuda.launches += 1
    return out


window_rows_cuda.launches = 0


def window_rows(cfg, y, dyws, ystarts, agg_table, ny, *, L: int, p0=None):
    """Backend-dispatched tier rows (the reference's
    ``fused_round.window_rows``).  Without ``p0``: the per-candidate Eq. 9
    ACF rows ``[..., K, L]``, as the reference returns them
    (:func:`window_acf_rows`; no kernel writes rows).  With ``p0``: their
    deviations from ``p0`` under ``cfg.measure``, ``[..., K]``, through the
    ``window_rows`` kernel where it serves (float32 card tensors,
    ``cfg.stat`` "acf", mae/rmse/cheb; ``window_rows_cuda``), else
    :func:`window_rows_plain`: the same bits."""
    if p0 is None:
        return window_acf_rows(y, dyws, ystarts, agg_table, ny, L=L)
    if y.dtype == torch.float32 and _ops._kernel_eligible(
            cfg.backend, cfg.stat, cfg.measure, y.device):
        return window_rows_cuda(y, dyws, ystarts, agg_table, ny, p0, L=L,
                                measure=cfg.measure)
    return window_rows_plain(y, dyws, ystarts, agg_table, ny, p0, L=L,
                             measure=cfg.measure)


# ---------------------------------------------------------------------------
# prefix scan (select="scan")
# ---------------------------------------------------------------------------

def prefix_moment_rows(y, dyws, ystarts, ok, ny, *, L: int):
    """Per-candidate aggregate-delta rows ``[K, 5, L]`` under the running
    reconstruction that applies every earlier ``ok`` candidate.

    ``dyws [K, Wy]`` are the candidates' aggregate-space delta windows in
    rank order, starting at ``ystarts [K]``; ``ok [K]`` gates which rank
    positions apply.  ``y`` must be zero-padded beyond ``ny``.
    """
    K, Wy = dyws.shape
    nyb = y.shape[0]
    dt = y.dtype
    d = dyws * ok.to(dt)[:, None]
    starts = torch.clamp(ystarts, 0, nyb - 1).long()
    # exclusive running delta field D_{<j}, as dense per-candidate rows
    cols = starts[:, None] + torch.arange(Wy, device=y.device)[None, :]
    place = torch.zeros((K, nyb + Wy), dtype=dt, device=y.device).scatter(
        1, cols, d)[:, :nyb]
    d_ex = _cumsum_xla(place, 0) - place
    # per-candidate context of the running reconstruction z = y + D_{<j}
    kk = torch.arange(Wy + 2 * L, device=y.device)
    gidx = starts[:, None] + kk[None, :]
    ctx = F.pad(y, (L, L + Wy))[gidx] + torch.gather(
        F.pad(d_ex, (L, L + Wy)), 1, gidx)
    return _moment_deltas(d, ctx, ystarts, ny, L=L)


def prefix_acf_rows_ref(y, dyws, ystarts, ok, agg_table, ny, *, L: int):
    """ACF rows ``[K, L]`` after each rank prefix of windowed removals (see
    :func:`prefix_moment_rows`)."""
    dt = y.dtype
    cum = _cumsum_xla(prefix_moment_rows(y, dyws, ystarts, ok, ny, L=L), 0)
    cum = cum + agg_table[None]
    l = torch.arange(1, L + 1, device=y.device)
    m = (ny - l).to(dt)[None, :]
    return _ref.acf_from_moments(cum[:, 0], cum[:, 1], cum[:, 2],
                                 cum[:, 3], cum[:, 4], m)


def prefix_devs_plain(y, dyws, ystarts, ok, agg_table, p0, ny, eps=None, *,
                      L: int, measure: str = "mae", greedy: bool = False):
    """Plain version of the ``prefix_devs`` kernel: the TPU kernel's walk.

    The running reconstruction ``z`` (``y`` padded by L on the left and
    L + Wy on the right) and the running moment table start from ``y`` and
    ``agg_table``; candidate k's delta ``dyws[k] * ok[k]`` at
    ``clip(ystarts[k], 0, nyb - 1)`` gives trial moments (window sums
    in XLA's row-reduce order, the order of the Pallas body's ``jnp.sum``)
    and the trial deviation ``devs[k]``.  Then the candidate
    commits to ``z`` and to the table: always (``greedy=False``) or where
    ``ok[k] & (devs[k] <= eps)`` (``greedy=True``).  Returns ``devs [K]``;
    lane by lane (``[B, K]``) for a batch.
    """
    if y.dim() == 2:
        def lane(v, b):
            return v[b] if torch.is_tensor(v) and v.dim() > 0 else v
        return torch.stack([
            prefix_devs_plain(y[b], dyws[b], ystarts[b], ok[b], agg_table[b],
                              p0[b], lane(ny, b), lane(eps, b), L=L,
                              measure=measure, greedy=greedy)
            for b in range(y.shape[0])])
    K, Wy = dyws.shape
    nyb = y.shape[0]
    dt = y.dtype
    dev = y.device
    z = F.pad(y, (L, L + Wy))
    agg5 = agg_table
    starts = torch.clamp(ystarts, 0, nyb - 1).long()
    okf = ok.to(dt)
    eps = torch.as_tensor(float("inf") if eps is None else eps, dtype=dt,
                          device=dev)
    j = torch.arange(Wy, device=dev)
    l = torch.arange(1, L + 1, device=dev)
    at = L + j                                         # z index of y[s + j]
    fwd = (L + l)[:, None] + j[None, :]                # [L, Wy]: y[s+j+l]
    bwd = (L - l)[:, None] + j[None, :]                #          y[s+j-l]
    dsh = l[:, None] + j[None, :]                      # d[j + l]
    m = (ny - l).to(dt)
    devs = []
    for k in range(K):
        s = starts[k]
        d = dyws[k] * okf[k]
        zat = z[s + at]
        e = d * (2.0 * zat + d)
        t = s + j
        head = (t[None, :] <= (ny - 1 - l)[:, None]).to(dt)      # [L, Wy]
        tail = (t[None, :] >= l[:, None]).to(dt)
        inner = (z[s + fwd] * head + z[s + bwd] * tail) \
            + F.pad(d, (0, L))[dsh] * head
        terms = torch.stack([d * head, d * tail, e * head, e * tail,
                             d * inner])                          # [5, L, Wy]
        trial = agg5 + _ref.row_sum_xla(terms)
        rho = _ref.acf_from_table(trial, m)
        dk = _ref.measure_rows(rho[None], p0, measure)[0]
        devs.append(dk)
        take = (okf[k] > 0) & (dk <= eps) if greedy else torch.ones(
            (), dtype=torch.bool, device=dev)
        z = z.index_put((s + at,), zat + take.to(dt) * d)
        agg5 = torch.where(take, trial, agg5)
    return torch.stack(devs)


_PREFIX_SYMBOL = {torch.float32: "prefix_devs_f32",
                  torch.float64: "prefix_devs_f64"}
# dynamic shared memory a block may use on the H100 (227 KB, less a margin
# for the kernel's static shared variables)
_SMEM_LIMIT = 232448 - 1024
# ranks the kernel compacts at a time and its most threads (one a lag; the
# lags past them keep their moments in scratch): kChunk and kMaxThreads in
# csrc/prefix_devs.cu
_PREFIX_CHUNK = 1024
_PREFIX_THREADS = 512


def prefix_devs_layout(Wy, nyb, L, item):
    """Whether a ``prefix_devs`` launch keeps ``z`` in shared memory, from
    the kernel's layout: the lags' terms, the staged deltas, e and the
    chunk's ok list always, ``z`` while it fits beside them (else global
    scratch)."""
    fixed = (L + 3 * Wy + _PREFIX_CHUNK) * item + 4 * _PREFIX_CHUNK
    if fixed > _SMEM_LIMIT:
        raise ValueError(f"prefix_devs: Wy={Wy} outgrows shared memory")
    return fixed + (nyb + 2 * L + Wy) * item <= _SMEM_LIMIT


def prefix_devs_cuda(y, dyws, ystarts, ok, agg_table, p0, ny, eps=None, *,
                     L: int, measure: str = "mae", greedy: bool = False):
    """Per-rank deviations ``[K]`` of the prefix walk (see
    :func:`prefix_devs_plain`), ``[B, K]`` for lanes: the CUDA kernel for
    card tensors (one block a lane), the plain version for CPU tensors.

    On the card the float operands share one dtype (float64 on the scan
    path), ``ystarts`` is int32, ``ok`` bool, and ``ny`` and ``eps`` are
    device tensors of one element a lane (int32 and the float dtype), so
    the launch needs no host sync.  The kernel walks only the ``ok`` ranks
    (the others get the committed deviation) and keeps ``z`` in shared
    memory while it fits the block's 227 KB, else in a global scratch
    buffer on the same code path (:func:`prefix_devs_layout`).  Past 512
    lags a thread takes several, and the moments of the lags past the first
    512 sit in that scratch buffer too.
    """
    if y.device.type != "cuda":
        return prefix_devs_plain(y, dyws, ystarts, ok, agg_table, p0, ny, eps,
                                 L=L, measure=measure, greedy=greedy)
    dev, dt = y.device, y.dtype
    if measure not in MEASURE_CODE:
        raise ValueError(f"prefix_devs reduces mae/rmse/cheb, got {measure!r}")
    if dt not in _PREFIX_SYMBOL:
        raise ValueError(f"prefix_devs: y must be float32 or float64, got {dt}")
    lead = tuple(y.shape[:-1])
    B = lead[0] if lead else 1
    if eps is None:
        eps = torch.full((B,), float("inf"), dtype=dt, device=dev)
    for name, t, want in (("y", y, dt), ("dyws", dyws, dt),
                          ("table", agg_table, dt), ("p0", p0, dt),
                          ("eps", eps, dt), ("ystarts", ystarts, torch.int32),
                          ("ok", ok, torch.bool), ("ny", ny, torch.int32)):
        if not (isinstance(t, torch.Tensor) and t.device == dev
                and t.dtype == want and t.is_contiguous()):
            raise ValueError(f"prefix_devs: {name} must be a contiguous "
                             f"{want} tensor on {dev}")
    K, Wy = dyws.shape[-2:]
    nyb = y.shape[-1]
    if (y.dim() not in (1, 2) or B < 1 or tuple(dyws.shape) != lead + (K, Wy)
            or tuple(ystarts.shape) != lead + (K,)
            or tuple(ok.shape) != lead + (K,) or ny.numel() != B
            or eps.numel() != B or tuple(agg_table.shape) != lead + (5, L)
            or tuple(p0.shape) != lead + (L,) or Wy < 1):
        raise ValueError(
            f"prefix_devs: shapes y {tuple(y.shape)}, dyws {tuple(dyws.shape)}"
            f", ystarts {tuple(ystarts.shape)}, ok {tuple(ok.shape)}, table "
            f"{tuple(agg_table.shape)}, p0 {tuple(p0.shape)} do not fit L={L}")
    out = torch.empty(lead + (K,), dtype=dt, device=dev)
    if K == 0:
        return out
    use_smem = prefix_devs_layout(Wy, nyb, L, y.element_size())
    # a lane's scratch: z where it is not in shared memory, then the
    # moments of the lags past the block's threads (csrc/prefix_devs.cu)
    n_scratch = (0 if use_smem else nyb + 2 * L + Wy) \
        + 10 * max(L - _PREFIX_THREADS, 0)
    scratch = torch.empty((max(B * n_scratch, 1),), dtype=dt, device=dev)
    fn = _build.bind("prefix_devs", _PREFIX_SYMBOL[dt], 10, 8)
    _build.check(fn(y.data_ptr(), dyws.data_ptr(), ystarts.data_ptr(),
                    ok.data_ptr(), agg_table.data_ptr(), p0.data_ptr(),
                    ny.data_ptr(), eps.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), K, Wy, nyb, L, MEASURE_CODE[measure],
                    int(greedy), int(use_smem), B,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "prefix_devs")
    prefix_devs_cuda.launches += 1
    return out


prefix_devs_cuda.launches = 0


def prefix_devs(cfg, y, dyws, ystarts, ok, agg, p0, ny):
    """Backend-dispatched deviation curve for one round's rank prefix: the
    kernel for eligible configurations on the card (``ny`` a 1-element
    int32 device tensor there), the reference rows elsewhere."""
    table = _ops.agg_to_table(agg)
    L = cfg.lags
    if _ops._kernel_eligible(cfg.backend, cfg.stat, cfg.measure, y.device):
        return prefix_devs_cuda(y, dyws, ystarts, ok, table, p0, ny, L=L,
                                measure=cfg.measure)
    rows = prefix_acf_rows_ref(y, dyws, ystarts, ok, table, ny, L=L)
    return _ops._rows_dev(cfg, rows, p0)


def greedy_feasible(cfg, y, dyws, ystarts, ok, agg, p0, ny, eps):
    """Backend-dispatched greedy feasible-subset selection for one round:
    walk the rank-ordered candidates once, committing each whose trial
    deviation on top of the committed set stays within ``eps`` (violators
    are skipped).  Returns ``(take [K] bool, devs [K])``.

    The kernel (eligible configurations on the card) keeps the exact
    committed reconstruction.  The reference form scans aggregate-delta
    rows whose contexts assume every earlier ``ok`` candidate applied, so a
    skip leaves a small bilinear error in later rows; callers re-validate
    the subset with the dense update.
    """
    table = _ops.agg_to_table(agg)
    L = cfg.lags
    dt = y.dtype
    if _ops._kernel_eligible(cfg.backend, cfg.stat, cfg.measure, y.device):
        devs = prefix_devs_cuda(y, dyws, ystarts, ok, table, p0, ny, eps,
                                L=L, measure=cfg.measure, greedy=True)
        return ok & (devs <= eps), devs
    dagg = prefix_moment_rows(y, dyws, ystarts, ok, ny, L=L)
    l = torch.arange(1, L + 1, device=y.device)
    m = (ny - l).to(dt)
    cum = table
    takes, devs = [], []
    for k in range(dagg.shape[0]):
        trial = cum + dagg[k]
        rho = _ref.acf_from_table(trial, m)
        dev = _ops._rows_dev(cfg, rho[None], p0)[0]
        take = ok[k] & (dev <= eps)
        cum = torch.where(take, trial, cum)
        takes.append(take)
        devs.append(dev)
    return torch.stack(takes), torch.stack(devs)
