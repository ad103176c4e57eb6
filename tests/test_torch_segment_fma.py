"""The Eq. 9 delta windows in the reference's bits (ROADMAP C19, C20), on
the CPU.

XLA fuses the line's multiply-add inside the reference's
``segment_deltas`` into one rounding, in its strict compilation too
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``),
though not in ``interpolate_at``; the port rounds it once with
``kernels.ref.fma_rn``.  Held here bit for bit against strict-compiled JAX
in a subprocess, with ``fma_rn`` against exact rational arithmetic.  The
aggregate map ``x_window_to_y`` equals the reference's at every kappa (2,
4 and aus_elec's 48): XLA's segment sum adds a cell's terms left to right
from zero, and so do the port's ``cell_sum`` and its plain version (C20);
a left-to-right oracle equals strict JAX too.
"""
import dataclasses
import os
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cameo as jc
from repro.core.aggregates import alive_neighbors as j_alive_neighbors
from repro.core.aggregates import segment_deltas as j_segment_deltas
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import cameo as tc
from repro_torch.core.aggregates import segment_deltas
from repro_torch.data.synthetic import dataset_cameo_kwargs, make_dataset
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import fma_rn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
# (dtype, kappa, W): the rounds' tier C window and tier B's; kappa 48 is
# aus_elec's
CASES = [(dt, kap, W) for dt in ("float32", "float64")
         for kap in (1, 2, 4, 48) for W in (64, 8)]


# the compress() run at kappa 48: an aus_elec stand-in of 4,800 points
# (100 target cells, L 7)
AUS_N = 4800
AUS_FIELDS = ("kept", "iters", "deviation", "xr")


def _aus_cfg():
    return jc.CameoConfig(eps=1e-2, **dataset_cameo_kwargs("aus_elec"))


def _case_id(case):
    return f"{case[0]}-k{case[1]}-W{case[2]}"


def _windows(dt: str, W: int, seed: int = 0):
    """(xr, prev, nxt, cand): a random reconstruction with 30% of 1,024
    points alive and every alive interior point a candidate."""
    rng = np.random.default_rng(seed + W)
    n = 1024
    xr = (rng.standard_normal(n) * 3).astype(dt)
    alive = rng.random(n) < 0.3
    alive[0] = alive[-1] = True
    prev, nxt = j_alive_neighbors(jnp.asarray(alive))
    cand = (np.nonzero(alive[1:-1])[0] + 1).astype(np.int32)
    return xr, np.asarray(prev), np.asarray(nxt), cand


def _twindows(dt: str, W: int):
    return tuple(torch.from_numpy(np.array(a)) for a in _windows(dt, W))


def _reference_main(out):
    """Strict JAX's delta windows and their aggregate map for every case."""
    res = {}
    for case in CASES:
        dt, kap, W = case
        cfg = jc.CameoConfig(kappa=kap, lags=8, dtype=dt)
        args = tuple(jnp.asarray(a) for a in _windows(dt, W))
        res[f"{_case_id(case)}/dwin"] = np.asarray(jax.jit(
            lambda *a: j_segment_deltas(*a, W)[0])(*args))
        res[f"{_case_id(case)}/dyw"] = np.asarray(jax.jit(
            lambda *a: jops.x_window_to_y(
                cfg, *j_segment_deltas(*a, W)[:2])[0])(*args))
    r = jc.compress(jnp.asarray(make_dataset("aus_elec", seed=0,
                                             length=AUS_N)), _aus_cfg())
    for f in AUS_FIELDS:
        res[f"aus/{f}"] = np.asarray(getattr(r, f))
    np.savez(out, **res)


@pytest.fixture(scope="module")
def strict(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_segment_fma") / "strict.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    log = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert log.returncode == 0, log.stdout + log.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _rn(exact: Fraction, dt) -> float:
    """``exact`` rounded to nearest, ties to even, in ``dt``."""
    x = dt(float(exact))
    around = (np.nextafter(x, dt(-np.inf)), x, np.nextafter(x, dt(np.inf)))
    ibits = np.int32 if dt == np.float32 else np.int64
    return min(around, key=lambda y: (abs(Fraction(float(y)) - exact),
                                      int(np.array(y).view(ibits)) & 1))


@pytest.mark.parametrize("dt", (np.float32, np.float64))
def test_fma_rn_rounds_once(dt):
    """``fma_rn(a, b, c)`` is ``a * b + c`` rounded once: random operands,
    the interpolation's (b a fraction k / m), and sums that cancel or sit
    near a tie of the separately rounded form."""
    rng = np.random.default_rng(7)
    n = 4000
    a = (rng.standard_normal(n) * 3).astype(dt)
    b = rng.random(n).astype(dt)
    c = (rng.standard_normal(n) * 3).astype(dt)
    m = rng.integers(2, 70, n)
    b[:1000] = (rng.integers(1, 70, 1000) % m[:1000]).astype(dt) / \
        m[:1000].astype(dt)
    c[1000:2000] = -(a[1000:2000] * b[1000:2000]).astype(dt)
    c[2000:2200] = 0
    got = fma_rn(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(c)).numpy()
    want = np.array([_rn(Fraction(float(x)) * Fraction(float(y))
                         + Fraction(float(z)), dt)
                     for x, y, z in zip(a, b, c)], dtype=dt)
    np.testing.assert_array_equal(got, want)
    # the separately rounded form parts from it somewhere
    assert np.any((c + (a * b).astype(dt)).astype(dt) != want)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == 1],
                         ids=_case_id)
def test_segment_deltas_equals_strict_reference(strict, case):
    dt, kap, W = case
    xr, prev, nxt, cand = _twindows(dt, W)
    dwin = segment_deltas(xr, prev, nxt, cand, W)[0].numpy()
    want = strict[f"{_case_id(case)}/dwin"]
    assert dwin.dtype == want.dtype
    np.testing.assert_array_equal(dwin, want)


def _sequential_segment_sum(dwin, start, kap):
    """XLA's segment sum as strict JAX runs it: each cell's terms added
    left to right from zero, in the windows' type; then divided by
    kappa."""
    W = dwin.shape[-1]
    Wy = W // kap + 2
    out = np.zeros(dwin.shape[:-1] + (Wy,), dwin.dtype)
    for r in range(dwin.shape[0]):
        b0 = start[r] // kap
        for j in range(W):
            c = (start[r] + j) // kap - b0
            out[r, c] = out[r, c] + dwin[r, j]
    return out / dwin.dtype.type(kap)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] > 1],
                         ids=_case_id)
def test_x_window_to_y_order(strict, case):
    """The aggregate map of strict JAX's own windows: XLA's sum is the
    left-to-right one, and the port's equals it at every kappa (C20: its
    one-hot sum took another order once a cell summed more than two
    terms)."""
    dt, kap, W = case
    xr, prev, nxt, cand = _twindows(dt, W)
    dwin, start, _ = segment_deltas(xr, prev, nxt, cand, W)
    want = strict[f"{_case_id(case)}/dyw"]
    np.testing.assert_array_equal(
        _sequential_segment_sum(dwin.numpy(), start.numpy(), kap), want)
    cfg = convert.config_from_dict(dataclasses.asdict(
        jc.CameoConfig(kappa=kap, lags=8, dtype=dt)))
    got, ystart = tops.x_window_to_y(cfg, dwin, start)
    assert got.dtype == dwin.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ystart.numpy(), start.numpy() // kap)


def test_aus_elec_rounds_at_kappa_48_equal_strict_reference(strict):
    """``compress()`` in rounds mode at aus_elec's kappa 48 and L 7 on 4,800
    points: the ranking windows' cells sum 48 terms each, and the kept
    mask, iterations, reconstruction and deviation equal strict JAX's bit
    for bit."""
    cfg = convert.config_from_dict(dataclasses.asdict(_aus_cfg()))
    assert cfg.kappa == 48 and cfg.lags == 7
    got = tc.compress(make_dataset("aus_elec", seed=0, length=AUS_N), cfg,
                      device="cpu")
    for f in AUS_FIELDS:
        want = strict[f"aus/{f}"]
        g = np.asarray(getattr(got, f).numpy())
        assert g.dtype == want.dtype and g.shape == want.shape, f
        assert np.array_equal(np.atleast_1d(g).view(np.uint8),
                              np.atleast_1d(want).view(np.uint8)), f
    assert int(got.iters) > 10


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    _reference_main(sys.argv[1])
