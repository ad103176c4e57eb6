#!/usr/bin/env python3
"""Which PyTorch reductions of the rounds body give a lane other bits in a
batch than alone, on one card.

    python3 tools/lane_bits.py [--lanes 16]

The round body's float64 sums: the prefix sums of the dense Eq. 10/11
update and of the Eq. 7 moments at init, the update's bilinear term (as
PyTorch computes them, ``torch.cumsum`` over the last axis and a batched
matrix product against a shift view, and as the port does, through the
``prefix_sum`` kernel, in XLA's cumsum order, ``lag_dot``'s cross form
and the ``dense_sxx`` kernel, which the update runs), the whole update, the kappa-mean of ``aggregate_series`` and the
kappa-sum of the x-to-y delta,
the one-hot segment sum of ``ops.x_window_to_y`` and the measure's mean
over the lags.  Each is computed on ``--lanes`` lanes of uk_elec- or
aus_elec-shaped data (seeded) and, lane by lane, on that lane alone (the
``[1, ...]`` shape ``compress_rounds`` gives it); prints, per op, how many
lanes keep their bits and the largest difference.  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import cameo  # noqa: E402
from repro_torch.core.acf import aggregate_series  # noqa: E402
from repro_torch.core.aggregates import apply_delta_dense  # noqa: E402
from repro_torch.core.measures import mae  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lane_bits: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    B = args.lanes
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64).to(dev)
    nyb, L = 18432, 48
    y, d = rand(B, nyb), 1e-3 * rand(B, nyb)
    tbl = rand(B, 5, L)
    ny = torch.full((B,), nyb - 912, dtype=torch.int32, device=dev)
    xk = rand(B, 245760)
    dwin = rand(B, 1843, 64)
    start = torch.randint(0, 5000, (B, 1843), generator=g).to(dev)
    rho, p0 = rand(B, L), rand(B, L)
    cfg48 = cameo.CameoConfig(kappa=48)

    def shifted(a, b):      # the dense update's bilinear term
        b_pad = torch.nn.functional.pad(b, (0, L))
        return (a.unsqueeze(-2) @ b_pad.unfold(-1, L, 1)[..., 1:nyb + 1, :]
                ).squeeze(-2)
    cases = {
        "cumsum [B, 18432]": (lambda b: torch.cumsum(d[b], -1),
                              lambda: torch.cumsum(d, -1)),
        "bilinear product [B, 1, 18432] x [B, 18432, 48]": (
            lambda b: shifted(d[b], y[b]), lambda: shifted(d, y)),
        "prefix_sum kernel, XLA's cumsum order [B, 18432] (the dense "
        "update's sums)": (
            lambda b: ops.prefix_sum(d[b]), lambda: ops.prefix_sum(d)),
        "lag_dot kernel, cross form [B, 18432] L 48 (its products)": (
            lambda b: ops.lag_dot(d[b], L, b=y[b]),
            lambda: ops.lag_dot(d, L, b=y)),
        "dense_sxx kernel [B, 18432] L 48 (the update's bilinear term, "
        "the reference's CPU order)": (
            lambda b: ops.dense_sxx(y[b], d[b], ny[b], L),
            lambda: ops.dense_sxx(y, d, ny, L)),
        "apply_delta_dense": (
            lambda b: apply_delta_dense(tbl[b], y[b], d[b], ny=ny[b]),
            lambda: apply_delta_dense(tbl, y, d, ny=ny)),
        "aggregate_series kappa 48 mean [B, 245760]": (
            lambda b: aggregate_series(xk[b], 48),
            lambda: aggregate_series(xk, 48)),
        "x-to-y kappa 48 sum [B, 245760]": (
            lambda b: cameo._x_to_y_delta(xk[b], 48),
            lambda: cameo._x_to_y_delta(xk, 48)),
        "x_window_to_y one-hot sum [B, 1843, 64]": (
            lambda b: ops.x_window_to_y(cfg48, dwin[b], start[b])[0],
            lambda: ops.x_window_to_y(cfg48, dwin, start)[0]),
        "mae over L [B, 48]": (lambda b: mae(rho[b], p0[b]),
                               lambda: mae(rho, p0)),
    }
    rows = []
    for name, (one, lanes) in cases.items():
        out = lanes()
        same, worst = 0, 0.0
        for b in range(B):
            # the shape a lane has alone: [1, ...] through the lane body
            sl = slice(b, b + 1)
            alone = one(sl)[0]
            same += bool(torch.equal(out[b], alone))
            worst = max(worst, float(torch.max(torch.abs(out[b] - alone))))
        rows.append(dict(op=name, lanes=B, lanes_same_bits=same,
                         max_abs_diff=worst))
        print("bits " + json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
