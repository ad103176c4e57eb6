"""The Eq. 9 window-axis and rank-axis sums in the reference's order
(ROADMAP C13, C14).

The reference sums a candidate's window in three XLA orders, and the port
takes each: ``jnp.cumsum`` over the window (the head and tail cuts of
``fused_round._moment_deltas``) and over the rank axis (``prefix_*``) in
XLA's blocked scan of base 16 (``kernels/prefix_sum.py``), ``jnp.sum``
over the window (the roll form's bilinear term) in XLA's row-reduce order
(``ref.row_sum_xla``, blocks of 32), and the contraction
``einsum("paw,pawl->pal")`` of ``ref._window_delta_acf`` one product at a
time from +0, with its basis ``(y_fwd + d_fwd) * head + y_bwd * tail``.
Before the repair the port chained every window and rank sum and
associated that basis otherwise; rows parted from the reference past 16
window values, and at any W in ``acf_after_window_delta_*``.

Held here at tolerance 0 against the JAX package compiled without XLA's
float rewrites (``--xla_disable_hlo_passes=algsimp
--xla_backend_optimization_level=0``, ROADMAP C1), in a subprocess, over
W (or Wy) in {8, 16, 32, 64} x L in {7, 12, 24, 48}, on seeded
``standard_normal`` rows with starts across the series and near both
ends: ``window_acf_rows`` (float32, the rounds path's tier rows),
``acf_after_window_delta_ctx`` and ``_rows`` (float64, the partitioned
ranking and the sequential ReHeap), ``_moment_deltas``,
``prefix_moment_rows`` and ``prefix_acf_rows_ref`` (float64).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_round as j_fused
from repro.kernels import ref as j_ref
from repro_torch.kernels import fused_round as t_fused
from repro_torch.kernels import ref as t_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
WINDOWS = (8, 16, 32, 64)
LAGS = (7, 12, 24, 48)
NY, NYB = 2048, 2112          # the series' valid length and its bucket
K_ROWS, K_PREFIX, P_CTX = 256, 64, 160


def _starts(rng, K, W):
    """Starts across the series, the first few at and near both ends (the
    rounds' bucket also sees starts past ``ny`` and below 0)."""
    s = rng.integers(0, NY - W, K)
    s[:8] = [0, 1, 3, W // 2, NY - W, NY - W - 1, NY - W - 5, NY - 2]
    s[8:10] = [-2, NYB + 3]
    return s.astype(np.int32)


def _inputs(W, L):
    rng = np.random.default_rng(1000 * W + L)
    y = np.zeros(NYB)
    y[:NY] = rng.standard_normal(NY)
    table = rng.standard_normal((5, L)) * 100
    starts = _starts(rng, K_ROWS, W)
    dw = rng.standard_normal((K_ROWS, W))
    ok = rng.random(K_PREFIX) < 0.7
    ctx = np.pad(y[:NY], (L, L + W))                 # the ctx form's chunk
    cstarts = np.clip(_starts(rng, P_CTX, W), 0, NY - W)
    cdw = rng.standard_normal((P_CTX, W))
    rows = np.stack([ctx[s:s + W + 2 * L] for s in cstarts])
    md_ctx = np.stack([np.pad(y, (L, L + W))[min(max(s, 0), NYB - 1):][
        :W + 2 * L] for s in starts])
    return dict(y=y, table=table, starts=starts, dw=dw, ok=ok, ctx=ctx,
                cstarts=cstarts, cdw=cdw, rows=rows, md_ctx=md_ctx)


def _reference(out_path):
    """Strict-compiled JAX over the grid, each function jitted whole."""
    jax.config.update("jax_enable_x64", True)
    out = {}
    for W in WINDOWS:
        for L in LAGS:
            a = _inputs(W, L)
            key = f"{W}/{L}"
            f32 = {k: a[k].astype(np.float32) for k in ("y", "dw", "table")}
            out[f"{key}/window_acf_rows"] = np.asarray(jax.jit(
                lambda *v: j_fused.window_acf_rows(*v, NY, L=L))(
                f32["y"], f32["dw"], a["starts"], f32["table"]))
            agg = tuple(a["table"])
            out[f"{key}/ctx"] = np.asarray(jax.jit(
                lambda g, *v: j_ref.acf_after_window_delta_ctx(
                    g, *v, ny=NY, off=0))(agg, a["ctx"], a["cstarts"],
                                          a["cdw"]))
            out[f"{key}/rows"] = np.asarray(jax.jit(
                lambda g, *v: j_ref.acf_after_window_delta_rows(
                    g, *v, ny=NY))(agg, a["rows"], a["cstarts"], a["cdw"]))
            out[f"{key}/moment_deltas"] = np.asarray(jax.jit(
                lambda *v: j_fused._moment_deltas(*v, NY, L=L))(
                a["dw"], a["md_ctx"], a["starts"]))
            k = K_PREFIX
            pargs = (a["y"], a["dw"][:k], a["starts"][:k], a["ok"])
            out[f"{key}/prefix_moment_rows"] = np.asarray(jax.jit(
                lambda *v: j_fused.prefix_moment_rows(*v, NY, L=L))(*pargs))
            out[f"{key}/prefix_acf_rows_ref"] = np.asarray(jax.jit(
                lambda *v: j_fused.prefix_acf_rows_ref(*v, NY, L=L))(
                *pargs, a["table"]))
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def strict(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_strict_window") / "strict.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", str(out)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _rows_differing(got, want):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    g = got.view(np.uint8).reshape(got.shape[0], -1)
    w = want.view(np.uint8).reshape(want.shape[0], -1)
    return int(np.any(g != w, axis=1).sum())


@pytest.mark.parametrize("L", LAGS)
@pytest.mark.parametrize("W", WINDOWS)
def test_window_sums_match_reference(strict, W, L):
    a = _inputs(W, L)
    T = torch.from_numpy
    key = f"{W}/{L}"
    f32 = {k: T(a[k].astype(np.float32)) for k in ("y", "dw", "table")}
    got = {
        "window_acf_rows": t_fused.window_acf_rows(
            f32["y"], f32["dw"], T(a["starts"]), f32["table"], NY, L=L),
        "ctx": t_ref.acf_after_window_delta_ctx(
            tuple(T(a["table"])), T(a["ctx"]), T(a["cstarts"]).long(),
            T(a["cdw"]), ny=NY, off=0),
        "rows": t_ref.acf_after_window_delta_rows(
            tuple(T(a["table"])), T(a["rows"]), T(a["cstarts"]).long(),
            T(a["cdw"]), ny=NY),
        "moment_deltas": t_fused._moment_deltas(
            T(a["dw"]), T(a["md_ctx"]), T(a["starts"]), NY, L=L),
    }
    k = K_PREFIX
    pargs = (T(a["y"]), T(a["dw"][:k]), T(a["starts"][:k]), T(a["ok"]))
    got["prefix_moment_rows"] = t_fused.prefix_moment_rows(*pargs, NY, L=L)
    got["prefix_acf_rows_ref"] = t_fused.prefix_acf_rows_ref(
        *pargs, T(a["table"]), NY, L=L)
    differ = {name: _rows_differing(v.numpy(), strict[f"{key}/{name}"])
              for name, v in got.items()}
    assert not any(differ.values()), differ
    # the loop oracle of _moment_deltas sums its lags' slices the same way
    md_ref = t_fused._moment_deltas_ref(T(a["dw"]), T(a["md_ctx"]),
                                        T(a["starts"]), NY, L=L)
    assert torch.equal(md_ref, got["moment_deltas"])


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
