#!/usr/bin/env python3
"""Drive the PyTorch port of CAMEO on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a wrong result:

1. device — a CUDA card is required; prints ``nvidia-smi``'s name and
   power limit;
2. build — compiles the kernels of ``src/repro_torch/kernels/csrc`` with
   nvcc into ``build/repro_torch/`` and prints the seconds and the ptxas
   report;
3. kernels — each hand-written kernel against its plain PyTorch version at
   the main paths' shapes of both datasets (uk_elec: n = 18,432, L = 48;
   aus_elec: nb = 245,760 onto nyb = 5,120, kappa = 48, L = 7), every
   measure, with the tolerance stated (0 for every kernel; lag_dot also
   gives the same bits on a second call, and its cross and halo forms are
   held, the halo form also on the partitioned mode's T partitions in one
   launch), timed with CUDA events (kernel, plain version and, for
   lag_dot, a PyTorch conv1d yardstick): the
   rounds mode's float32 kernels, the float64 forms of the sequential mode
   (acf_impact at init, acf_window_impact at the ReHeap's P = 50 and at
   the partitioned mode's ranking chunk, T x min(4,096, n / T) rows) and
   the scan's prefix walk (prefix_devs, greedy and not, held exactly: a
   random walk over each dataset's k_max ranks, and the real lock-step
   round 3 of each dataset's scan, its arguments captured through the
   round body's hook, with K, the ok count and the interior count); the
   two Eq. 9 window kernels are held exactly too, also on a
   boundary-heavy case each (every start within L + W of either end,
   with its interior count); cell_sum (the Eq. 9 windows' cells in XLA's
   segment-sum order, C20) at aus_elec's tiers B and C (kappa 48, float64),
   on 4 lanes and in float32, held exactly and timed beside an
   ``index_add_``; segment_cells (every path's Eq. 9 delta windows from
   the segments' endpoints to their cells, C19 and C20) at both datasets'
   tiers B and C, on ``KERNEL_LANES`` lanes (each lane against its launch
   alone) and in float32 with int64 candidates, on the neighbours of an
   alive mask with segments past W, every output held exactly and timed
   beside its plain version and the pair it replaces (``segment_deltas``
   then ``x_window_to_y``), device time and a synchronised call's wall;
   prefix_sum (the Eq. 7 moments' and the dense
   update's prefix sums: one row, the pair of rows the main path launches,
   and pairs of 1, 17, 4,097 and 65,537 values) held exactly to its plain
   version on the CPU (XLA's cumsum order, jnp.cumsum's bits) and timed
   beside torch.cumsum on the card; dense_sxx (the dense update's bilinear
   term, the reference's CPU order) held exactly to its plain version on a
   round's delta, also at min_temp's 365 lags; and an empty kernel, built
   and bound as
   the others, timed as the launch floor.  Then the kernels of the rounds
   path with a lane axis, one launch for a batch (uk_elec B = 16, aus_elec
   B = 4; lag_dot's self and cross forms, prefix_sum (the lanes' pairs of
   rows), dense_sxx, acf_impact, window_rows; prefix_devs 2 lanes of
   uk_elec's random walk): each against its plain
   version at its tolerance and, lane by lane, bit for bit against its
   one-lane launch;
4. main paths — ``compress()`` on the card with, for each run, every
   kernel of its path launched, deviation <= eps, a from-scratch float64
   re-measure on the CPU agreeing to 1e-9, endpoints kept and kept values
   bit-exact: rounds mode (``select="backoff"``) and ``select="scan"`` at
   full width and length on uk_elec (n = 17,520, L = 48) and aus_elec
   (n = 230,688, L = 7, kappa = 48), and ``mode="sequential"`` at the
   quickstart's widths (hops 24, window 64) on uk_elec (4,096 points, and
   its whole year, 17,520, on the card alone) and aus_elec (4,800).
   Backoff and sequential CRs are held within 5% of the
   same call on the CPU (run in two worker processes that start with
   phase 3 and go on beside the card's phases; the card-only run comes
   first), and the backoff runs equal it in kept mask, iterations and the
   deviation's bits; the scan's CR is reported beside the CPU path's
   (which runs the linearized branch, the card the greedy one) and the
   card's backoff CR.  Then the batch: ``compress_batch`` of uk_elec
   (B = 16, seeds 0..15) and aus_elec (B = 4), each lane held against its
   per-series ``compress_rounds`` on the card (kept mask, iterations and
   the deviation's bits),
   uk_elec at B = 64 timed only, and ``compress_multivariate`` of an
   uk_elec-shaped ``[17,520, 4]``; every lane and column passes the
   guarantee checks above, and a round launches acf_impact at most twice
   and window_rows at most 2 x 2 times (two lane groups), whatever B;
   Then the streaming phase (``core/streaming.py`` into ``store/``, with
   the telemetry registry on): uk_elec (17,520 points, windows of 4,096,
   the feed in seeded chunks of 1-3,000 points) at queue depths 1 and 4
   and as one chunk, aus_elec (its first 71,360 points, windows of 4,080)
   at queue depths 1 and 8, and a uk_elec-shaped ``[17,520, 4]``
   multivariate stream: kept masks and ``xr`` bits equal across chunkings
   and depths, each full window equal to ``compress()`` of its slice,
   every compressed window within eps by a float64 re-measure, the
   stream's ``deviation()`` within 1e-9 of a from-scratch measure, a
   mid-stream ``state_dict`` resumed to the same bits, the windows written
   through ``open_stream`` into a store read back bit-equal (and the
   file's bytes equal between the depths), the build watermark flat, and
   the CR within 5% of the same stream on the CPU; wall s, points per
   second, ``lag_dot`` halo launches and ``compress_batch`` calls
   reported;
   Then the facade phase (``repro_torch.api``, ``repro_torch.server`` and
   ``repro_torch.serving.ts_service`` on the card, ``run_facade``):
   ``api.open(path, cfg, device="cuda")``'s ``write`` of uk_elec and
   aus_elec at full length, their file bytes equal to
   ``CameoStore.append_series`` of the port's own ``compress()``; the
   pushdown mean, variance, ACF and PACF over [1,000, 16,000) within
   their bounds of the exact statistics; ``write_batch`` of 16 uk_elec
   stand-ins as one ``compress_batch``, lanes 0, 7 and 15 stored as solo
   writes store them; a multivariate ``[17,520, 4]`` write; a scan and a
   sequential write; an ``IngestServer`` (small sealed blocks, background
   compaction) with four sessions of 17,520 points, two tenants, pushed
   from four host threads at once, every series' blocks and entry equal
   to the same sessions run one after another, a push past the "acme"
   tenant's quota refused before the journal, ``stats()`` and the
   ``/metrics`` text counting the pushes and points, and a
   ``resume=True`` reopen answering the same; the service shim's 8
   submits byte-equal to ``write_batch``; every kernel launched; a
   ``facade step`` line a step and a ``facade {...}`` line;
   Then the partitioned phase (``core/parallel.py``, ``run_partitioned``):
   ``compress_partitioned`` of uk_elec in T = 8 partitions and aus_elec in
   T = 6 at full length, each with its guarantee, every kernel of its path
   launched (acf_window_impact once an impact chunk a round, whatever T),
   held against the same run through the plain versions on the card (the
   same iterations, CR within 5%), with its rounds' telemetry (accepted,
   rejected, alpha), and its first rounds equal to the same rounds on the
   CPU bit for bit;
   ``compress_partitioned_local`` of uk_elec (T = 8); on NCCL at world
   size 1, the shard form held to the global form of one partition and
   ``compress_batch(mesh=)`` of 16 uk_elec stand-ins held to the unsharded
   batch, bit for bit; ``partitioned {...}`` lines and the card's name and
   power limit;
   Then the baselines phase (``baselines/``, ``run_baselines``), eps =
   1e-2: the five line-simplification ranks through ``compress_baseline``
   on uk_elec and aus_elec at full length, each with the guarantee above;
   PMC, Swing, Sim-Piece and FFT through ``acf_constrained_search`` at 8
   steps, each deviation re-measured on the CPU; Gorilla's and Chimp's
   bits per value equal to their loop forms; lag_dot, prefix_sum,
   dense_sxx and segment_scan launched on the path; uk_elec's kept masks,
   rounds, every round's deviation bits and the searches' parameters and
   storage equal to the same calls on the CPU (run in two worker
   processes that start after phase 4); ``baseline {...}`` lines with
   rounds, CR and seconds, Sim-Piece's host seconds apart.  Then
   segment_scan (the PMC and Swing scans) against its plain version at
   tolerance 0 in both modes at both datasets' full lengths, at the error
   bound each search settled on and 10 times it, timed with CUDA events
   (its launches there do not count).  Then the serving phase (the model
   zoo's attention path, ``run_serving``): qwen3-0.6b at its published
   width in bfloat16, weights from seed 0, ``Engine.generate`` greedy on
   8 prompts of 2,048 tokens (the chunked prefill) and 32 new tokens, a
   warm and a timed call with equal tokens in range (prefill s, decode ms
   a token, tokens/s, peak memory); CAMEO's KV selection, ``prune_tree``
   of the prefill caches (28 layers x 8 rows of 2,080 positions, keep 512,
   16 lags: 224 lanes of one ``compress_batch``, its kernel launches
   counted, rounds from the telemetry), the first and last layers' lanes
   held to the CPU path (run in a worker process) in their series' bits
   and kept slots, the kept entries bit-exact copies, then 8 decode steps
   on the compacted cache; the bfloat16 prefill's last-position logits
   and a first decode step (2 rows) within 1e-1 x RMS of the float32
   ``forward`` over the same tokens, greedy tokens equal outside
   near-ties; the same weights in float32, where 32 decode
   steps after a 1,024-token prefill equal ``forward``'s logits over 2,048
   tokens within 1e-3 x RMS; qwen3-0.6b reduced from the same seed on the
   card and the CPU, logits within 1e-4 x RMS and greedy tokens equal but
   at near-ties; ``serve {...}`` lines and the card's name and power
   limit.  Then the MoE and Mamba2 phase (``run_serving_zoo``):
   qwen3-moe-235b-a22b at its published width cut to 4 layers (weights
   drawn on the card from seed 0), generation as above with each layer's
   dropped assignments at prefill, its KV selection (32 lanes) held as
   above, a float32 one-layer cache path at capacity factor 8 (16 decode
   steps after a 1,024-token prefill against ``forward``, 1e-3 x RMS),
   ``moe_apply_a2a`` on NCCL at world size 1 against the scatter path
   (1e-3 x RMS); mamba2-2.7b whole, generation and a float32 cache path
   (a 1,000-token prefill ending inside a chunk); the reduced qwen3-moe,
   kimi-k2, mamba2 and jamba configs card against CPU (1e-4 x RMS; routes
   equal but at near-ties, counted).  Then the training phase
   (``run_training``): uk_elec compressed by ``compress()`` on the card
   (its rounds path's kernels counted, the guarantee held), decompressed,
   tokenized against the raw series (2,048 codes) into 65 windows of
   1,024; musicgen-large at its published width (48 layers, d 2,048,
   bfloat16, remat "full", AdamW with bfloat16 state, weights drawn on the
   card from seed 0) trained by ``train_loop`` at B = 8 for 1 + 6 timed
   steps (finite losses, the last below the first), then 3 steps with the
   stacked leaves read as views [i]; a ``train {...}`` line with the
   compress's CR, seconds and launches, the losses, the median step s,
   tokens/s, peak memory, the step's operations (``train_ops``) and their
   share of the bfloat16 dense peak; the reduced config (float32, the
   CPU draw) 4 steps on the card and in a CPU worker (losses within
   ``TRAIN_LOSS_TOL`` relative, every leaf within ``TRAIN_LEAF_TOL`` x its
   largest |value|); its 8-step run against 4 steps, a checkpoint, a restore and
   4 more, bit-equal under ``torch.use_deterministic_algorithms``; and
   ``launch.train.main`` for 3 steps of the reduced config on the card;
5. the lock-step check — a scan round on uk_elec from one carry on the
   card: the greedy branch with the prefix_devs kernel and with its plain
   version must take the same candidates; segment_cells launched on each
   of ``SEGMENT_CELLS_PATHS``; then the seconds of each phase and a
   ``{"kernels": [...]}`` line (each kernel's launches also by path);
6. the last line, ``{"ok": true, "device": {...}}``.

The torch.profiler breakdowns of the main paths and the pass that finds
where aus_elec's card run parts from its CPU run are in
``tools/profile_paths.py``.

It imports nothing of JAX or of the JAX package.  ``run_phases`` is the
same sequence for any device and size; the CPU tests rehearse it on tiny
inputs, where the wrappers take their plain versions.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import math
import multiprocessing
import os
import json
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import baselines as _bl  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import sharding as _shd  # noqa: E402
from repro_torch.baselines import functional as _functional  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.core import cameo  # noqa: E402
from repro_torch.core import parallel as _par  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.core.acf import (acf, acf_from_aggregates,  # noqa: E402
                                  aggregate_series, extract_aggregates,
                                  pacf_from_acf)
from repro_torch.core.aggregates import (alive_neighbors,  # noqa: E402
                                         segment_deltas)
from repro_torch.data.synthetic import (dataset_cameo_kwargs,  # noqa: E402
                                        make_dataset)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import acf_impact as _acf_impact  # noqa: E402
from repro_torch.kernels import acf_window_impact as _awi  # noqa: E402
from repro_torch.kernels import cell_sum as _cell_sum  # noqa: E402
from repro_torch.kernels import dense_sxx as _dense_sxx  # noqa: E402
from repro_torch.kernels import fused_round as _fused  # noqa: E402
from repro_torch.kernels import lag_dot as _lag_dot  # noqa: E402
from repro_torch.kernels import ops as _ops  # noqa: E402
from repro_torch.kernels import prefix_sum as _prefix_sum  # noqa: E402
from repro_torch.kernels import ref as _ref  # noqa: E402
from repro_torch.kernels import segment_cells as _segcells  # noqa: E402
from repro_torch.kernels import segment_scan as _segscan  # noqa: E402
from repro_torch.models import moe as _moe  # noqa: E402
from repro_torch.models import moe_a2a as _moe_a2a  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.configs.base import layer_ctx  # noqa: E402
from repro_torch.models.model import (_index, decode_step,  # noqa: E402
                                      forward, model_defs, prefill)
from repro_torch.data.pipeline import (SeriesTokenizer,  # noqa: E402
                                       forecast_batches, series_windows)
from repro_torch.launch import train as _launch_train  # noqa: E402
from repro_torch.launch.specs import default_train_config  # noqa: E402
from repro_torch.models.params import count_params, init_params  # noqa: E402
from repro_torch.serving import kv_prune  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.store import CameoStore  # noqa: E402
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: E402
from repro_torch.train.step import TrainConfig, build_train_step  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12          # FP64 outside the tensor cores
FP32_FLOPS = 67e12          # FP32 outside the tensor cores

WRAPPERS = {"lag_dot": _lag_dot.lag_dot_cuda,
            "acf_impact": _acf_impact.acf_impact_cuda,
            "window_rows": _fused.window_rows_cuda,
            "acf_window_impact": _awi.acf_window_impact_cuda,
            "prefix_devs": _fused.prefix_devs_cuda,
            "prefix_sum": _prefix_sum.prefix_sum_cuda,
            "dense_sxx": _dense_sxx.dense_sxx_cuda,
            "segment_scan": _segscan.segment_scan_cuda,
            "cell_sum": _cell_sum.cell_sum_cuda,
            "segment_cells": _segcells.segment_cells_cuda}
# each kernel's wrapper as its callers look it up: (module, attribute)
CALLERS = {"acf_window_impact": ((_ops, "acf_window_impact_cuda"),),
           "window_rows": ((_fused, "window_rows_cuda"),),
           "acf_impact": ((cameo, "acf_impact_cuda"),
                          (_ops, "acf_impact_cuda")),
           "lag_dot": ((_ops, "lag_dot_cuda"),),
           "prefix_devs": ((_fused, "prefix_devs_cuda"),),
           "prefix_sum": ((_ops, "prefix_sum_cuda"),),
           "dense_sxx": ((_ops, "dense_sxx_cuda"),),
           "segment_scan": ((_functional, "segment_scan_cuda"),),
           "cell_sum": ((_ops, "cell_sum_cuda"),),
           "segment_cells": ((_ops, "segment_cells_cuda"),)}
SOURCES = {"lag_dot": "src/repro_torch/kernels/csrc/lag_dot.cu",
           "acf_impact": "src/repro_torch/kernels/csrc/acf_impact.cu",
           "window_rows": "src/repro_torch/kernels/csrc/window_rows.cu",
           "acf_window_impact":
               "src/repro_torch/kernels/csrc/acf_window_impact.cu",
           "prefix_devs": "src/repro_torch/kernels/csrc/prefix_devs.cu",
           "prefix_sum": "src/repro_torch/kernels/csrc/prefix_sum.cu",
           "dense_sxx": "src/repro_torch/kernels/csrc/dense_sxx.cu",
           "segment_scan": "src/repro_torch/kernels/csrc/segment_scan.cu",
           "cell_sum": "src/repro_torch/kernels/csrc/cell_sum.cu",
           "segment_cells": "src/repro_torch/kernels/csrc/segment_cells.cu"}
REPLACES = {"lag_dot": "src/repro/kernels/lag_dot.py:42",
            "acf_impact": "src/repro/kernels/acf_impact.py:93",
            "window_rows": "src/repro/kernels/fused_round.py:276",
            "acf_window_impact": "src/repro/kernels/acf_window_impact.py:77",
            "prefix_devs": "src/repro/kernels/fused_round.py:382",
            # XLA's jnp.cumsum, no Pallas kernel: aggregates.py:71,73 and
            # acf.py:52-53,77-78
            "prefix_sum": "src/repro/core/aggregates.py:71",
            # the dense update's bilinear term, jnp's roll form on the CPU,
            # no Pallas kernel
            "dense_sxx": "src/repro/core/aggregates.py:93",
            # XLA's jax.lax.scan of PMC (:36) and of Swing (:81), no Pallas
            # kernel
            "segment_scan": "src/repro/baselines/functional.py:36",
            # XLA's jax.ops.segment_sum in x_window_to_y, no Pallas kernel
            "cell_sum": "src/repro/kernels/ops.py:256",
            # the reference's segment_deltas and, at kappa > 1, XLA's
            # segment_sum in x_window_to_y, no Pallas kernel
            "segment_cells": "src/repro/core/aggregates.py:298 + "
                             "src/repro/kernels/ops.py:256"}
# Each output is held to its plain version elementwise: |got - want| <=
# rtol |want| + floor max|want|.  The floor scales with the output, so an
# output of the wrong scale (zeros, say) fails whatever the inputs' size.
# Every kernel rounds each operation as its plain version does and sums in
# its order, so it is held exactly: the rankings, the Eq. 7 tables and the
# scan's decisions depend on every bit.  lag_dot chains each lag's products
# left to right as its plain version (the JAX reference's order) does on
# the CPU; prefix_sum is held exactly to its plain version on the CPU: both
# take XLA's cumsum order (torch.cumsum's order is another, on the card
# and on the CPU).
TOL = {"lag_dot": (0.0, 0.0), "acf_impact": (0.0, 0.0),
       "window_rows": (0.0, 0.0), "acf_window_impact": (0.0, 0.0),
       "prefix_devs": (0.0, 0.0), "prefix_sum": (0.0, 0.0),
       "dense_sxx": (0.0, 0.0), "segment_scan": (0.0, 0.0),
       "cell_sum": (0.0, 0.0), "segment_cells": (0.0, 0.0),
       # cell_sum's library yardstick (index_add_, atomics in the card's
       # order) sums a cell's at most kappa terms in another order
       "cell_sum_index_add": (1e-12, 1e-12),
       "cell_sum_index_add_f32": (1e-5, 1e-5),
       # the library yardsticks (conv1d) of lag_dot and dense_sxx sum in
       # their own order (float64; dense_sxx's float32 launches of the KV
       # selection in float32)
       "conv1d": (1e-10, 1e-10), "dense_sxx_conv1d": (1e-10, 1e-10),
       "dense_sxx_conv1d_f32": (1e-5, 1e-5)}
DATASETS = ("uk_elec", "aus_elec")
MEASURES = ("mae", "rmse", "cheb")
EPS = 1e-2
# the main paths of phase 4: (name, CameoConfig overrides, kernels the path
# launches, whether its CR is held within 5% of the CPU path's)
PATHS = {
    "rounds": (dict(), ("lag_dot", "prefix_sum", "dense_sxx", "acf_impact",
                        "window_rows", "segment_cells"), True),
    "scan": (dict(select="scan"), ("lag_dot", "prefix_sum", "dense_sxx",
                                   "acf_impact", "window_rows",
                                   "prefix_devs", "segment_cells"), False),
    "sequential": (dict(mode="sequential", hops=24, window=64),
                   ("lag_dot", "prefix_sum", "acf_impact",
                    "acf_window_impact", "segment_cells"), True),
}
# the paths whose runs must launch segment_cells (the Eq. 9 windows of every
# path, at every kappa), as the {"kernels"} line's launches_by_path names
# them
SEGMENT_CELLS_PATHS = ("rounds", "scan", "sequential", "batch",
                       "partitioned", "stream", "serving_selection")
# the batch phase (``compress_batch``): (dataset, lanes, whether each lane
# is held against its per-series ``compress_rounds`` run on the card in the
# same call); uk_elec at B = 64 is timed only (its per-series runs would
# take ~75 s)
BATCHES = (("uk_elec", 16, True), ("aus_elec", 4, True),
           ("uk_elec", 64, False))
# ``compress_multivariate``: uk_elec-shaped columns (seeds 0..C-1)
MV_COLUMNS = 4
# phase 3's batched shapes: lanes a launch at each dataset, and the lanes of
# prefix_devs' batched random walk (uk_elec only: its plain version walks
# each lane's 1,843 ranks one op at a time, ~3.6 s a lane on the card)
KERNEL_LANES = {"uk_elec": 16, "aus_elec": 4}
PREFIX_LANES = 2
# window_rows launches a round body makes (tiers B and C); a round launches
# acf_impact once and window_rows TIERS times for each of its (at most two)
# lane groups, whatever the lanes
TIERS = 2
# the streaming phase: (case, dataset, points, window, queue depths, whether
# the feed also goes in as one chunk); the window is the JAX package's
# default (4,096) rounded down to a multiple of kappa; uk_elec's year gives
# 4 full windows and a 1,136-point tail, aus_elec's first 71,360 points 17
# full windows and a 2,000-point tail (1,968 compressed at ny 41, a
# 32-point kappa remainder kept verbatim)
STREAMS = (("uk_elec", "uk_elec", 17520, 4096, (1, 4), True),
           ("aus_elec", "aus_elec", 71360, 4080, (1, 8), False))
STREAM_MV_COLUMNS = 4
# chunk sizes of the seeded feed
STREAM_CHUNKS = (1, 3000)
# the sequential mode's lengths (the quickstart's documented 4,096 points
# for uk_elec, 100 y cells of kappa = 48 for aus_elec): it pops one point
# per iteration, each a few ms of eager host dispatch on the card
SEQ_LENGTHS = {"uk_elec": 4096, "aus_elec": 4800}
# the longer sequential run on the card alone: uk_elec's whole year
SEQ_FULL_YEAR = 17520
# the partitioned phase (``core/parallel.py``): (dataset, T partitions) of
# the global form at full length (T divides n / kappa: uk_elec 2,190
# points a partition, aus_elec 38,448 = 801 target cells); the local form
# of the first; the shard form and ``compress_batch(mesh=)`` (uk_elec
# B = 16) on NCCL at world size 1 (one card)
PARTITIONED = (("uk_elec", 8), ("aus_elec", 6))
PART_BATCH = 16
# rounds of the CPU run each partitioned run is held against bit for bit:
# a CPU round ranks every point by Eq. 9 in plain torch (~1.6 s at uk_elec's
# 17,520 on the card machine), so a full-length CPU run does not fit the
# time limit; the full-length run is held against the same run on the card
# through the plain versions (``backend="reference"``) instead
PART_CPU_ROUNDS = 6
# the main paths' CPU runs (the bulk of the script's host time) run in
# worker processes beside the card's phases: workers, and torch threads
# each (the CPU path's bits do not depend on the thread count)
CPU_REF_WORKERS = 2
CPU_REF_THREADS = 3


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def device_ms(fn, device, reps: int = 7, inner: int = 20):
    """Median device time of one call of ``fn`` in ms (CUDA events around
    ``inner`` back-to-back calls, enqueued while the card is held busy so
    host overhead does not enter); None on the CPU."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def timed_once(fn, device):
    """``(fn(), ms)``: one call timed with CUDA events (None on the CPU),
    for plain versions too slow to repeat."""
    if device.type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _peak(dtype) -> float:
    return FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _item(dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


def lag_dot_bound(B, n, L, dtype):
    """lag_dot's self form on B lanes of n points: each lane read once
    (with its L-point tail), its L sums written; 2 operations a (point,
    lag) term."""
    return bound_ms(B * (n + L) * _item(dtype), B * 2.0 * n * L,
                    _peak(dtype))


def acf_impact_bound(B, P, nyb, L, dtype):
    """acf_impact on B lanes of P points: per (point, lag) 7 for the five
    moment updates, 12 for Eq. 2 with its sqrt and divide, 3 for the
    measure; per point 3 for e = d (2 y + d).  Bytes: y, the deltas,
    table + p0, the output."""
    return bound_ms(B * (nyb + 2 * P + 6 * L) * _item(dtype),
                    B * P * (22.0 * L + 3), _peak(dtype))


def check_close(what: str, kname: str, got, want) -> float:
    """Hold ``got`` to ``want`` under ``TOL[kname]``; max abs error."""
    rtol, floor = TOL[kname]
    err = torch.abs(got - want)
    scale = float(torch.max(torch.abs(want)))
    require(scale > 0, f"{what}: the plain version is all zeros")
    bad = int(torch.sum(err > rtol * torch.abs(want) + floor * scale))
    worst = float(torch.max(err))
    require(bad == 0, f"{what} disagrees with its plain version: {bad} of "
                      f"{want.numel()} outputs out of tolerance, max abs "
                      f"error {worst} (max|plain| {scale})")
    return worst


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_inputs(device, name: str, length=None, seed: int = 0):
    """The main path's kernel inputs at init for dataset ``name``: the
    target series ``y`` (the Def. 2 aggregate of the padded bucket), its
    Eq. 7 table and ACF, and the Eq. 8 deltas of the first round (each
    point against the line through its neighbours)."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=seed, length=length)
    n = (x.shape[0] // cfg.kappa) * cfg.kappa
    x = x[:n]
    nb = cameo._round_bucket(n, cfg)
    xp = np.pad(x, (0, nb - n))
    y64 = aggregate_series(torch.from_numpy(xp), cfg.kappa).to(device)
    ny = n // cfg.kappa
    agg = extract_aggregates(y64[:ny].cpu(), cfg.lags, backend="reference")
    table = torch.stack(list(agg)).to(device)
    p0 = acf_from_aggregates(table, ny)
    dx = np.zeros(nb)
    dx[1:n - 1] = 0.5 * (xp[:n - 2] + xp[2:n]) - xp[1:n - 1]
    dval = torch.from_numpy(dx / cfg.kappa).to(device)
    return cfg, n, nb, ny, y64, table, p0, dval


def prefix_sum_entry(device, name: str, x: torch.Tensor, lanes=None) -> dict:
    """prefix_sum on the rows of ``x`` (``[..., n]``, one launch) against its
    plain version on the CPU at tolerance 0, each leading index (a lane, or
    a row of a pair) against its own launch; timed beside its plain version
    and torch.cumsum on the card.  ``lanes``: the batch this launch serves,
    recorded on the entry."""
    rows = x.numel() // x.shape[-1]
    what = f"{name} prefix_sum {list(x.shape)}"
    got = _prefix_sum.prefix_sum_cuda(x)
    err = check_close(what, "prefix_sum", got, _prefix_sum.prefix_sum_plain(
        x.cpu()).to(x.device))
    if x.dim() > 1:
        require_lanes(what, got, lambda b: _prefix_sum.prefix_sum_cuda(x[b]))
    bnd, by = bound_ms(2 * x.element_size() * x.numel(), float(x.numel()),
                       FP64_FLOPS if x.dtype == torch.float64 else FP32_FLOPS)
    per = rows // (lanes or 1)
    shape = (f"B={lanes} lanes x " if lanes else "") + \
        f"{per} row{'s' if per > 1 else ''} x n={x.shape[-1]} " \
        f"{str(x.dtype)[6:]}"
    return dict(name="prefix_sum", shape=shape, max_abs_err=err,
                ms=device_ms(lambda: _prefix_sum.prefix_sum_cuda(x), device),
                plain_ms=device_ms(lambda: _prefix_sum.prefix_sum_plain(x),
                                   device),
                library_ms=device_ms(lambda: torch.cumsum(x, dim=-1), device),
                bound_ms=bnd, bound_by=by,
                **({"lanes": lanes} if lanes else {}))


def dense_delta(y: torch.Tensor, ny: int, seed: int = 0) -> torch.Tensor:
    """A round's dense delta on the target series ``y [nyb]``: a tenth of
    its first ``ny`` points moved by 5% of the series' spread, zero
    elsewhere."""
    rng = np.random.default_rng(seed)
    d = np.zeros(y.shape[-1])
    at = rng.random(ny) < 0.1
    d[:ny][at] = rng.standard_normal(int(at.sum())) * 0.05 * float(
        torch.std(y[:ny].cpu()))
    return torch.from_numpy(d).to(y.device)


def dense_sxx_entry(device, name: str, y: torch.Tensor, d: torch.Tensor,
                    ny, L: int, lanes=None) -> dict:
    """dense_sxx on ``y``, ``d`` (``[nyb]``, or ``[B, nyb]`` with ``ny`` one
    a lane) against its plain version on the CPU at tolerance 0, each lane
    against its own launch; timed beside its plain version on the card."""
    what = f"{name} dense_sxx {list(y.shape)}"
    got = _dense_sxx.dense_sxx_cuda(y, d, ny, L)
    ny_cpu = ny.cpu() if isinstance(ny, torch.Tensor) else ny
    err = check_close(what, "dense_sxx", got, _dense_sxx.dense_sxx_plain(
        y.cpu(), d.cpu(), ny_cpu, L).to(got.device))
    if lanes:
        require_lanes(what, got, lambda b: _dense_sxx.dense_sxx_cuda(
            y[b], d[b], ny[b], L))
    nyb, B = y.shape[-1], lanes or 1
    nys = (ny.reshape(-1).expand(B) if isinstance(ny, torch.Tensor)
           else torch.full((B,), ny)).cpu()
    # reads y and d, writes [B, L]; z = y + d once a point, then a term of
    # every unmasked (point, lag) is two products and an add, and its add
    # into the lag's sum
    terms = sum(max(int(n) - l, 0) for n in nys for l in range(1, L + 1))
    item = y.element_size()
    bnd, by = bound_ms(2 * item * B * nyb + item * B * L,
                       4.0 * terms + float(nys.sum()), _peak(y.dtype))
    # the library's one call: a grouped two-channel convolution, lane b's
    # [z, d] (zeros past its ny and L more) against its [d, y] (zeros past
    # ny); output l is sum_t d_t z_{t+l} + y_t d_{t+l} over the unmasked t
    live = (torch.arange(nyb, device=y.device)
            < nys.to(y.device)[:, None]).to(y.dtype)
    ym, dm = y.reshape(B, nyb) * live, d.reshape(B, nyb) * live
    signal = F.pad(torch.stack([ym + dm, dm], 1).reshape(1, 2 * B, nyb),
                   (0, L))
    weight = torch.stack([dm, ym], 1)

    def conv():
        return F.conv1d(signal, weight, groups=B)[0, :, 1:].reshape(got.shape)
    check_close(f"{what} conv1d yardstick", "dense_sxx_conv1d" if
                y.dtype == torch.float64 else "dense_sxx_conv1d_f32", conv(),
                got)
    return dict(name="dense_sxx", shape=(f"B={lanes} lanes x " if lanes
                                         else "") + f"nyb={nyb} L={L} "
                                                    f"{str(y.dtype)[6:]}",
                max_abs_err=err,
                ms=device_ms(lambda: _dense_sxx.dense_sxx_cuda(y, d, ny, L),
                             device),
                plain_ms=device_ms(lambda: _dense_sxx.dense_sxx_plain(
                    y, d, ny, L), device, reps=3, inner=3),
                library_ms=device_ms(conv, device), bound_ms=bnd, bound_by=by,
                **({"lanes": lanes} if lanes else {}))


# lengths of prefix_sum's pairs of rows off the datasets' shapes: one value,
# one group past XLA's 16, one value past a 4,096-value tile, and 17 tiles
# (a cluster of 8 blocks, levels above the tiles)
PREFIX_SUM_LENGTHS = (1, 17, 4097, 65537)


def phase_kernels(device, name: str, length=None) -> list:
    """Each kernel against its plain version at ``name``'s main-path
    shapes; one entry per kernel and shape (window_rows: its two tier
    launches of one full-size round together, then its boundary-heavy
    case)."""
    cfg, _, _, ny, y64, *_ = kernel_inputs(device, name, length)
    L, nyb = cfg.lags, y64.shape[0]
    out = []

    # lag_dot: Eq. 7 sxx at init, float64 (the self form reads y once),
    # the same bits on a second call; and the cross and halo forms
    got = _lag_dot.lag_dot_cuda(y64, L=L)
    want = _lag_dot.lag_dot_plain(y64, L=L)
    err = check_close(f"{name} lag_dot", "lag_dot", got, want)
    require(torch.equal(_lag_dot.lag_dot_cuda(y64, L=L), got),
            f"{name} lag_dot: two calls gave different bits")
    other = torch.flip(y64, (0,)).contiguous()
    for form in ((other, None), (other, y64[:L])):
        err = max(err, check_close(
            f"{name} lag_dot ({'halo' if form[1] is not None else 'cross'})",
            "lag_dot", _lag_dot.lag_dot_cuda(y64, *form, L=L),
            _lag_dot.lag_dot_plain(y64, *form, L=L)))
    # the halo form on the partitioned mode's T partitions, one launch,
    # each partition as alone
    T = dict(PARTITIONED).get(name, 1)
    m = (nyb // T) if T > 1 else nyb
    parts = y64[:T * m].reshape(T, m)
    halos = torch.cat([parts[1:, :L], torch.zeros_like(parts[:1, :L])])
    got_p = _lag_dot.lag_dot_cuda(parts, parts, halos, L=L)
    err = max(err, check_close(f"{name} lag_dot (halo, {T} partitions)",
                               "lag_dot", got_p, _lag_dot.lag_dot_plain(
                                   parts, parts, halos, L=L)))
    require_lanes(f"{name} lag_dot (halo, {T} partitions)", got_p,
                  lambda b: _lag_dot.lag_dot_cuda(parts[b], parts[b],
                                                  halos[b], L=L))
    b_ext = _lag_dot.extended_operand(y64, L=L)

    def conv():
        return F.conv1d(b_ext[1:].view(1, 1, -1), y64.view(1, 1, -1)).view(-1)
    if device.type == "cuda":
        check_close(f"{name} conv1d yardstick", "conv1d", conv(), want)
    bnd, by = lag_dot_bound(1, nyb, L, torch.float64)
    out.append(dict(
        name="lag_dot", shape=f"n={nyb} L={L} float64", max_abs_err=err,
        ms=device_ms(lambda: _lag_dot.lag_dot_cuda(y64, L=L), device),
        plain_ms=device_ms(lambda: _lag_dot.lag_dot_plain(y64, L=L), device),
        library_ms=device_ms(conv, device), bound_ms=bnd, bound_by=by))

    # prefix_sum, float64: one row of y, then the pair one launch takes on
    # the main path (y and y^2 for the Eq. 7 moments at init; the dense
    # update's delta and e, of the same length, every round); off the
    # datasets' shapes, pairs of PREFIX_SUM_LENGTHS (with uk_elec)
    out.append(prefix_sum_entry(device, name, y64))
    out.append(prefix_sum_entry(device, name, torch.stack([y64, y64 * y64])))
    if name == DATASETS[0]:
        rng = np.random.default_rng(5)
        for n in PREFIX_SUM_LENGTHS:
            out.append(prefix_sum_entry(device, name, torch.from_numpy(
                rng.standard_normal((2, n))).to(device)))

    # dense_sxx, the dense update's bilinear term every round: the bucket's
    # y and a round's delta
    out.append(dense_sxx_entry(device, name, y64, dense_delta(y64, ny), ny,
                               L))

    # acf_impact: Eq. 8 impacts of every point, float32 (the rounds), and
    # float64 (the sequential init)
    acf_cases = acf_impact_cases(device, name, length)
    out.append(acf_impact_entry(device, name, acf_cases[0]))

    # window_rows: Eq. 9 tier impacts at the full-size round's capacities
    # (tiers B and C together, as one round launches them), then a
    # boundary-heavy case
    tiers = [window_rows_entry(device, name, c)
             for c in window_rows_cases(device, name, length)]
    row = dict(tiers[0])
    main = tiers[:2]
    row["shape"] = " + ".join(t["shape"] for t in main)
    row["max_abs_err"] = max(t["max_abs_err"] for t in main)
    for key in ("ms", "plain_ms", "bound_ms"):
        vals = [t[key] for t in main]
        row[key] = None if None in vals else sum(vals)
    row["bound_by"] = max(main, key=lambda t: t["bound_ms"])["bound_by"]
    out.append(row)
    out += tiers[2:]
    out += [window_impact_entry(device, c)
            for c in window_impact_cases(device, name, length)]
    out.append(acf_impact_entry(device, name, acf_cases[1]))
    out += [prefix_case(device, c["label"], c["args"], c["eps"], L,
                        mixed=c["mixed"])
            for c in prefix_cases(device, name, length)]
    if cfg.kappa > 1:
        out += cell_sum_entries(device, name, length)
    out += segment_cells_entries(device, name, length)
    for r in out:
        r["dataset"] = name
    if name == DATASETS[0]:
        # dense_sxx past 32 lags: min_temp's L = 365 on its bucket, one
        # series
        c365, _, _, n365, y365, *_ = kernel_inputs(device, "min_temp",
                                                   length)
        out.append(dict(dense_sxx_entry(device, "min_temp", y365,
                                        dense_delta(y365, n365), n365,
                                        c365.lags), dataset="min_temp"))
    return out


def _edge_starts(rng, ny: int, W: int, L: int, n: int) -> np.ndarray:
    """``n`` window starts within L + W of either end of [0, ny - W]:
    boundary-heavy, most windows meet a head or a tail mask."""
    hi = ny - W
    return np.concatenate([
        rng.integers(0, min(L + W, hi + 1), n - n // 2),
        rng.integers(max(0, hi - L - W), hi + 1, n // 2)]).astype(np.int32)


def window_rows_cases(device, name: str, length=None) -> list:
    """window_rows' phase-3 cases at ``name``'s main-path shapes: tier B
    (spans 2..8) and tier C (9..64) at the full-size round's capacities,
    mapped onto y, with starts across the series; then a boundary-heavy
    case at tier C's shape, every start within L + Wy of either end.  Each
    holds its label, K, Wy, L, nyb, interior count and the wrapper's
    arguments."""
    cfg, _, nb, ny, y64, table, p0, dval = kernel_inputs(device, name,
                                                         length)
    L, kap = cfg.lags, cfg.kappa
    rng = np.random.default_rng(2)
    ny_t = torch.full((), ny, dtype=torch.int32, device=device)
    scale = float(torch.std(dval.float())) * kap
    W, WB = cfg.window, cameo._TIER_SMALL_W
    KB, KC = min(nb, max(24, nb // 24)), min(nb, max(16, nb // 48))
    cases = []
    for label, K, Wx, edge in (("tier B", KB, WB, False),
                               ("tier C", KC, W, False),
                               ("boundary-heavy", KC, W, True)):
        Wy = Wx if kap == 1 else Wx // kap + 2
        st = _edge_starts(rng, ny, Wy, L, K) if edge else \
            rng.integers(1, ny - Wy, K).astype(np.int32)
        starts = torch.from_numpy(st).to(device)
        dyws = torch.from_numpy(
            (rng.standard_normal((K, Wy)) * scale).astype(np.float32)
        ).to(device)
        cases.append(dict(
            label=label, K=K, Wy=Wy, L=L, nyb=y64.shape[0],
            interior=int(_ref.interior_windows(starts, Wy, L, ny).sum()),
            args=(y64.float(), dyws, starts, table.float(), ny_t,
                  p0.float())))
    return cases


def window_rows_bound(K, Wy, L, nyb):
    """Per (candidate, lag): 4 Wy for the bilinear sum, 2 for the tail
    sums, 5 to add the table, 12 for Eq. 2, 3 for the measure; per
    candidate 3 Wy for e and 2 Wy for the prefix sums of d and e.  Bytes:
    deltas, starts, the context y once, table + p0, the output."""
    return bound_ms(
        (K * Wy + K + min(nyb, K * (Wy + 2 * L)) + 6 * L + K) * 4,
        K * (L * (4.0 * Wy + 22) + 5.0 * Wy), FP32_FLOPS)


def window_rows_entry(device, name: str, c: dict) -> dict:
    """window_rows against its plain version on case ``c`` under every
    measure; one phase-3 entry, timed under mae."""
    K, Wy, L, args = c["K"], c["Wy"], c["L"], c["args"]
    err = 0.0
    cfg, _, _ = _path_cfg(name, "rounds")
    for measure in MEASURES:
        got = _fused.window_rows_cuda(*args, L=L, measure=measure)
        err = max(err, check_close(
            f"{name} window_rows {c['label']} (K={K}, Wy={Wy}, {measure})",
            "window_rows", got,
            _fused.window_rows_plain(*args, L=L, measure=measure)))
        # the public dispatch (the reference's fused_round.window_rows) is
        # the wrapper's launch on the card
        disp = _fused.window_rows(dataclasses.replace(cfg, measure=measure),
                                  *args[:5], L=L, p0=args[5])
        require(_same_bits(disp, got),
                f"{name} window_rows {c['label']} ({measure}): the dispatch "
                f"differs from the wrapper")
    bnd, by = window_rows_bound(K, Wy, L, c["nyb"])
    return dict(
        name="window_rows",
        shape=f"{c['label']}: K={K} Wy={Wy} L={L} interior={c['interior']} "
              f"float32",
        max_abs_err=err,
        ms=device_ms(lambda: _fused.window_rows_cuda(
            *args, L=L, measure="mae"), device),
        plain_ms=device_ms(lambda: _fused.window_rows_plain(
            *args, L=L, measure="mae"), device),
        library_ms=None, bound_ms=bnd, bound_by=by)


def cell_sum_bound(R: int, W: int, Wy: int, dtype):
    """Bytes: the windows and their starts read once, the cells written;
    operations: W adds and Wy divisions a window."""
    it = _item(dtype)
    return bound_ms(R * (W * it + 4 + Wy * it), R * (W + Wy), _peak(dtype))


def cell_sum_entries(device, name: str, length=None) -> list:
    """cell_sum against its plain version at tolerance 0 on ``name``'s
    rounds shapes (tier B's and tier C's capacities, x windows of
    ``_TIER_SMALL_W`` and ``window`` points in the run's float64; one entry
    for the round's two launches), the tier C shape on ``KERNEL_LANES``
    lanes and in float32; timed beside its plain version and an
    ``index_add_`` (with its zeros and the division), held within its
    tolerance."""
    cfg, _, nb, ny, *_ = kernel_inputs(device, name, length)
    kap = cfg.kappa
    rng = np.random.default_rng(8)
    KB, KC = min(nb, max(24, nb // 24)), min(nb, max(16, nb // 48))
    lanes = KERNEL_LANES.get(name, 1)
    cases = (("tier B", (KB,), cameo._TIER_SMALL_W, torch.float64),
             ("tier C", (KC,), cfg.window, torch.float64),
             ("tier C lanes", (lanes, KC), cfg.window, torch.float64),
             ("tier C float32", (KC,), cfg.window, torch.float32))
    rows = []
    for label, lead, W, dt in cases:
        x = torch.from_numpy(rng.standard_normal(lead + (W,))).to(
            device=device, dtype=dt)
        x[..., W // 2:] *= torch.from_numpy(
            rng.random(lead + (W - W // 2,)) < 0.5).to(device)
        st = torch.from_numpy(rng.integers(1, nb - W, lead).astype(
            np.int32)).to(device)
        Wy = W // kap + 2
        got = _cell_sum.cell_sum_cuda(x, st, kap)
        want = _cell_sum.cell_sum_plain(x, st, kap)
        what = f"{name} cell_sum {label} (kappa={kap}, W={W})"
        err = check_close(what, "cell_sum", got, want)
        require(_same_bits(got, want), f"{what}: not the plain version's bits")
        R = int(np.prod(lead))
        seg = ((st[..., None].long() + torch.arange(W, device=device))
               // kap - (st.long() // kap)[..., None])
        idx = (torch.arange(R, device=device).reshape(lead)[..., None]
               * Wy + seg).reshape(-1)
        src = x.reshape(-1)

        def library():
            out = torch.zeros(R * Wy, dtype=dt, device=device)
            return _ref.div_exact(out.index_add_(0, idx, src), kap)
        if device.type == "cuda":
            check_close(f"{what} index_add_ yardstick",
                        "cell_sum_index_add" if dt == torch.float64
                        else "cell_sum_index_add_f32",
                        library().reshape(want.shape), want)
        shape = (f"{label}: {'x'.join(map(str, lead))} windows W={W} "
                 f"Wy={Wy} kappa={kap} {str(dt)[6:]}")
        bnd, by = cell_sum_bound(R, W, Wy, dt)
        rows.append(dict(
            name="cell_sum", shape=shape, max_abs_err=err,
            ms=device_ms(lambda: _cell_sum.cell_sum_cuda(x, st, kap), device),
            plain_ms=device_ms(lambda: _cell_sum.cell_sum_plain(x, st, kap),
                               device, reps=3, inner=5),
            library_ms=device_ms(library, device), bound_ms=bnd,
            bound_by=by))
    # the round's two launches (tiers B and C) as one entry, first
    main = dict(rows[0])
    main["shape"] = rows[0]["shape"] + " + " + rows[1]["shape"]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [r[key] for r in rows[:2]]
        main[key] = None if None in vals else sum(vals)
    main["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return [main] + rows[2:]


def host_ms(fn, device, reps: int = 21):
    """Median wall time of one synchronised call of ``fn`` in ms, the host's
    dispatch included (None on the CPU)."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def segment_geometry(rng, n: int, W: int, lanes=None):
    """``(prev, nxt)`` of an alive mask over ``n`` points (each of
    ``lanes`` lanes its own): the endpoints alive, the gaps between alive
    points half of 1-8 points, half of 9 to 2W (segments past W present)."""
    rows = []
    for _ in range(lanes or 1):
        m = n // 4 + 2
        gaps = np.where(rng.random(m) < 0.5, rng.integers(1, 9, m),
                        rng.integers(9, 2 * W + 1, m))
        alive = np.zeros(n, dtype=bool)
        pos = np.cumsum(gaps)
        alive[pos[pos < n]] = True
        alive[0] = alive[-1] = True
        rows.append(alive)
    alive = torch.from_numpy(np.stack(rows) if lanes else rows[0])
    return alive_neighbors(alive)


def segment_candidates(rng, prev: torch.Tensor, nxt: torch.Tensor, K: int,
                       lo: int, hi: int) -> np.ndarray:
    """``K`` candidates of one lane: the two endpoints, then alive points
    whose segment after removal spans ``lo..hi`` points (7 in 8) or more
    than ``hi`` (1 in 8), drawn with repeats."""
    p, q = prev.numpy(), nxt.numpy()
    n = p.shape[0]
    idx = np.arange(n)
    alive = np.zeros(n, dtype=bool)
    alive[q[q < n]] = True
    alive[0] = alive[-1] = True
    span = q - p - 1
    inner = idx[alive & (span >= lo) & (span <= hi)]
    over = idx[alive & (span > hi)]
    inner = inner if inner.size else idx[alive]
    over = over if over.size else inner
    take = rng.random(K) < 7 / 8
    out = np.where(take, rng.choice(inner, K), rng.choice(over, K))
    out[:2] = (0, n - 1)
    return out


def segment_cells_bound(xr, prev, nxt, cand, W: int, kappa: int):
    """Bytes these inputs need: each candidate, p and q at it, x at the
    two endpoints and at the min(span, W) interior points its window
    covers, and the cells, ystart and span written; operations: 6 a term
    (the index conversion, the division, the FMA's two, the subtraction and
    the mask) and at kappa > 1 an add a term and a division a cell."""
    it = xr.element_size()
    i = torch.as_tensor(cand)
    span = (_ref.gather_clamped(nxt, i) - _ref.gather_clamped(prev, i) - 1)
    covered = float(torch.clamp(span, 0, W).sum())
    R = span.numel()
    Wy = W // kappa + 2 if kappa > 1 else W
    nbytes = R * (i.element_size() + 8 + 2 * it + Wy * it + 8) + covered * it
    flops = R * W * 6.0 + (R * (W + Wy) if kappa > 1 else 0.0)
    return bound_ms(nbytes, flops, _peak(xr.dtype))


def segment_cells_hold(what: str, args) -> float:
    """segment_cells' kernel against its plain version on ``args`` (xr,
    prev, nxt, cand, W, kappa): every output bit for bit, the x-space
    window too, and cells that are not all zero; the cells' max abs
    error."""
    got = _segcells.segment_cells_cuda(*args, x_window=True)
    want = _segcells.segment_cells_plain(*args, x_window=True)
    for part, g, w in zip(("cells", "ystart", "span", "dwin", "start"), got,
                          want):
        require(_same_bits(g, w),
                f"{what}: {part} not the plain version's bits")
    return check_close(what, "segment_cells", got[0], want[0])


def segment_cells_entries(device, name: str, length=None) -> list:
    """segment_cells against its plain version at tolerance 0 on ``name``'s
    rounds shapes (tier B's and tier C's capacities, windows of
    ``_TIER_SMALL_W`` and ``window`` points, float64, int32 candidates; one
    entry for the round's two launches), the tier C shape on
    ``KERNEL_LANES`` lanes (each lane also against its one-lane launch) and
    in float32 with int64 candidates (the scan's); the geometry is the
    neighbours of an alive mask over the dataset's bucket with segments
    past W, the endpoints among the candidates.  Timed beside its plain
    version and the pair it replaces on the card (``segment_deltas`` and
    ``x_window_to_y``), device time and a synchronised call's wall."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    kap, W, WB = cfg.kappa, cfg.window, cameo._TIER_SMALL_W
    x = make_dataset(name, seed=0, length=length)
    n = (x.shape[0] // kap) * kap
    nb = cameo._round_bucket(n, cfg)
    xp = np.pad(x[:n], (0, nb - n))
    rng = np.random.default_rng(11)
    KB, KC = min(nb, max(24, nb // 24)), min(nb, max(16, nb // 48))
    lanes = KERNEL_LANES.get(name, 1)
    cases = (("tier B", None, KB, WB, 2, torch.float64, np.int32),
             ("tier C", None, KC, W, WB + 1, torch.float64, np.int32),
             ("tier C lanes", lanes, KC, W, WB + 1, torch.float64, np.int32),
             ("tier C float32", None, KC, W, WB + 1, torch.float32,
              np.int64))
    rows = []
    for label, B, K, Wx, lo, dt, idt in cases:
        prev, nxt = segment_geometry(rng, nb, Wx, B)
        if B:
            xr = torch.from_numpy(np.stack([np.roll(xp, 97 * b)
                                            for b in range(B)]))
            cand = np.stack([segment_candidates(rng, prev[b], nxt[b], K, lo,
                                                Wx) for b in range(B)])
        else:
            xr = torch.from_numpy(xp)
            cand = segment_candidates(rng, prev, nxt, K, lo, Wx)
        ci = torch.from_numpy(cand.astype(idt))
        # the bound reads the candidates at the width the kernel reads
        bnd, by = segment_cells_bound(xr.to(dt), prev, nxt, ci, Wx, kap)
        xr = xr.to(device=device, dtype=dt)
        prev, nxt, ci = prev.to(device), nxt.to(device), ci.to(device)
        args = (xr, prev, nxt, ci, Wx, kap)
        what = f"{name} segment_cells {label} (kappa={kap}, W={Wx})"
        err = segment_cells_hold(what, args)
        if B:
            require_lanes(what, _segcells.segment_cells_cuda(*args)[0],
                          lambda b: _segcells.segment_cells_cuda(
                              xr[b], prev[b], nxt[b], ci[b], Wx, kap)[0])

        def kernel():
            return _segcells.segment_cells_cuda(*args)

        def plain():
            return _segcells.segment_cells_plain(*args)

        def pair():
            return _ops.x_window_to_y(cfg, *segment_deltas(
                xr, prev, nxt, ci, Wx)[:2])
        Wy = Wx // kap + 2 if kap > 1 else Wx
        shape = (f"{label}: {f'{B}x' if B else ''}{K} windows W={Wx} Wy={Wy} "
                 f"kappa={kap} {str(dt)[6:]} {np.dtype(idt).name} "
                 f"candidates, spans {lo}..{Wx} and past")
        rows.append(dict(
            name="segment_cells", shape=shape, max_abs_err=err,
            ms=device_ms(kernel, device),
            plain_ms=device_ms(plain, device, reps=3, inner=5),
            pair_ms=device_ms(pair, device, reps=3, inner=5),
            wall_ms=host_ms(kernel, device),
            pair_wall_ms=host_ms(pair, device),
            library_ms=None, bound_ms=bnd, bound_by=by))
    # the round's two launches (tiers B and C) as one entry, first
    main = dict(rows[0])
    main["shape"] = rows[0]["shape"] + " + " + rows[1]["shape"]
    for key in ("ms", "plain_ms", "pair_ms", "wall_ms", "pair_wall_ms",
                "bound_ms"):
        vals = [r[key] for r in rows[:2]]
        main[key] = None if None in vals else sum(vals)
    main["bound_by"] = max(rows[:2], key=lambda r: r["bound_ms"])["bound_by"]
    main["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return [main] + rows[2:]


def window_impact_cases(device, name: str, length=None) -> list:
    """acf_window_impact's phase-3 cases, float64, W = 64 mapped onto y:
    the sequential ReHeap's P = 2(hops + 1) = 50 with starts across the
    series; the partitioned mode's ranking chunk (the T partitions'
    candidates of one impact chunk, one launch: T x min(impact_chunk, n /
    T) rows, ``PARTITIONED``'s T); and a boundary-heavy ReHeap, every start
    within L + W of either end."""
    cfg, n, _, ny, y64, table, p0, _ = kernel_inputs(device, name, length)
    L, kap = cfg.lags, cfg.kappa
    rng = np.random.default_rng(3)
    W = 64 if kap == 1 else 64 // kap + 2
    scale = float(torch.std(y64[:ny])) * 0.05
    T = dict(PARTITIONED).get(name, 1)
    P_part = T * min(cfg.impact_chunk, n // T)
    specs = [("ReHeap", 50, False),
             (f"partitioned ranking chunk, T={T}", P_part, False),
             ("boundary-heavy ReHeap", 50, True)]
    cases = []
    for label, P, edge in specs:
        st = _edge_starts(rng, ny, W, L, P) if edge else \
            rng.integers(0, ny - W, P).astype(np.int32)
        starts = torch.from_numpy(st).to(device)
        dw = torch.from_numpy(rng.standard_normal((P, W)) * scale).to(device)
        ctx = _ref.candidate_contexts(y64[:ny], starts, L=L, W=W)
        cases.append(dict(
            label=label, P=P, W=W, L=L, ny=ny,
            interior=int(_ref.interior_windows(starts, W, L, ny).sum()),
            args=(ctx, dw, starts, table, p0)))
    return cases


def window_impact_entry(device, c: dict) -> dict:
    """acf_window_impact against its plain version on case ``c`` under
    every measure; one phase-3 entry, timed under mae."""
    P, W, L, ny, args = c["P"], c["W"], c["L"], c["ny"], c["args"]
    err = 0.0
    for measure in MEASURES:
        kw = dict(ny=ny, L=L, measure=measure)
        err = max(err, check_close(
            f"acf_window_impact {c['label']} (P={P}, W={W}, {measure})",
            "acf_window_impact", _awi.acf_window_impact_cuda(*args, **kw),
            _awi.acf_window_impact_plain(*args, **kw)))
    kw = dict(ny=ny, L=L, measure="mae")
    bnd, by = window_impact_bound(P, W, L, 8, FP64_FLOPS)
    return dict(
        name="acf_window_impact",
        shape=f"{c['label']}: P={P} W={W} L={L} interior={c['interior']} "
              f"float64",
        max_abs_err=err,
        ms=device_ms(lambda: _awi.acf_window_impact_cuda(*args, **kw),
                     device),
        plain_ms=device_ms(lambda: _awi.acf_window_impact_plain(
            *args, **kw), device, reps=3, inner=3),
        library_ms=None, bound_ms=bnd, bound_by=by)


def launch_floor_ms(device):
    """Median device time of an empty kernel built and bound as the port's
    kernels are (csrc/launch_floor.cu): the least any launch takes."""
    if device.type != "cuda":
        return None
    fn = _build.bind("launch_floor", "launch_floor", 0, 0)

    def launch():
        _build.check(fn(torch.cuda.current_stream(device).cuda_stream),
                     "launch_floor")
    return device_ms(launch, device)


def window_impact_bound(P, W, L, item, peak):
    """Bytes: contexts, deltas, starts, table + p0, output.  Operations the
    function needs, counted as for window_rows (the head and tail masks
    select a prefix and a suffix of the window): per (candidate, lag) 4 W
    for the bilinear sum, 2 for the tail sums, 5 to add the table, 12 for
    Eq. 2, 3 for the measure; per candidate 3 W for e and 2 W for the
    prefix sums of d and e."""
    return bound_ms((P * (W + 2 * L) + P * W + 6 * L + P) * item + 4 * P,
                    P * (L * (4.0 * W + 22) + 5.0 * W), peak)


def acf_impact_cases(device, name: str, length=None) -> list:
    """acf_impact's phase-3 cases at ``name``'s main-path shapes: the
    rounds' float32 impacts of every point of the padded bucket (runtime
    ny, the i // kappa map), then the sequential init's float64 impacts
    over SEQ_LENGTHS points (random deltas).
    Each holds its label, P, L, kappa, item size, the wrapper's arguments
    and keywords (without the measure) and its bound."""
    cfg, _, nb, ny, y64, table, p0, dval = kernel_inputs(device, name,
                                                         length)
    L, kap, nyb = cfg.lags, cfg.kappa, y64.shape[0]
    rng = np.random.default_rng(1)
    ny_t = torch.full((), ny, dtype=torch.int32, device=device)
    n_seq = SEQ_LENGTHS["uk_elec" if kap == 1 else "aus_elec"]
    y_s = y64[:n_seq // kap].contiguous()
    agg_s = extract_aggregates(y_s.cpu(), L, backend="reference")
    t_s = torch.stack(list(agg_s)).to(device)
    p_s = acf_from_aggregates(t_s, y_s.shape[0])
    d_s = torch.from_numpy(rng.standard_normal(n_seq)
                           * float(torch.std(y_s)) * 0.05).to(device)
    return [
        dict(label="rounds", P=nb, L=L, kappa=kap, item=4,
             shape=f"P={nb} nyb={nyb} kappa={kap} L={L} float32",
             args=(y64.float(), dval.float(), table.float(), p0.float()),
             kw=dict(L=L, ny=ny_t, kappa=kap),
             bound=acf_impact_bound(1, nb, nyb, L, torch.float32)),
        dict(label="sequential init", P=n_seq, L=L, kappa=kap, item=8,
             shape=f"P={n_seq} ny={y_s.shape[0]} kappa={kap} L={L} float64 "
                   f"(sequential init)",
             args=(y_s, d_s, t_s, p_s), kw=dict(L=L, kappa=kap),
             bound=acf_impact_bound(1, n_seq, y_s.shape[0], L,
                                    torch.float64))]


def acf_impact_entry(device, name: str, c: dict) -> dict:
    """acf_impact against its plain version on case ``c`` under every
    measure (tolerance 0); one phase-3 entry, timed under mae."""
    args, kw = c["args"], c["kw"]
    err = 0.0
    for measure in MEASURES:
        err = max(err, check_close(
            f"{name} acf_impact {c['label']} ({measure})", "acf_impact",
            _acf_impact.acf_impact_cuda(*args, measure=measure, **kw),
            _acf_impact.acf_impact_plain(*args, measure=measure, **kw)))
        if c["kappa"] == 1 and args[1].shape[-1] == args[0].shape[-1]:
            # the public dispatch (the reference's ops.acf_impact: every
            # point, its full length) is the wrapper's launch on the card
            want = _acf_impact.acf_impact_cuda(*args, L=c["L"],
                                               measure=measure)
            require(_same_bits(_ops.acf_impact(*args, measure=measure),
                               want),
                    f"{name} acf_impact {c['label']} ({measure}): the "
                    f"dispatch differs from the wrapper")
    bnd, by = c["bound"]
    return dict(
        name="acf_impact", shape=c["shape"], max_abs_err=err,
        ms=device_ms(lambda: _acf_impact.acf_impact_cuda(
            *args, measure="mae", **kw), device),
        plain_ms=device_ms(lambda: _acf_impact.acf_impact_plain(
            *args, measure="mae", **kw), device),
        library_ms=None, bound_ms=bnd, bound_by=by)


def prefix_cases(device, name: str, length=None) -> list:
    """prefix_devs' phase-3 cases at ``name``'s shapes, float64: a random
    walk over the scan's k_max ranks (70% ok, eps at the middle of its
    prefix curve, so the greedy walk both commits and skips), then the
    arguments of the dataset's real lock-step scan round.  Each holds its
    label, the wrapper's arguments (y, dyws, ystarts, ok, table, p0, ny),
    eps and whether the greedy walk must skip too."""
    cfg, _, nb, ny, y64, table, p0, _ = kernel_inputs(device, name, length)
    L, kap = cfg.lags, cfg.kappa
    rng = np.random.default_rng(4)
    scale = float(torch.std(y64[:ny])) * 0.05
    K = max(1, min(int(cfg.alpha * nb), nb - 2))
    Wy = cfg.window if kap == 1 else cfg.window // kap + 2
    starts = torch.from_numpy(
        rng.integers(1, ny - Wy, K).astype(np.int32)).to(device)
    dyws = torch.from_numpy(rng.standard_normal((K, Wy))
                            * scale * 0.2).to(device)
    ok = torch.from_numpy(rng.random(K) > 0.3).to(device)
    ny_t = torch.full((1,), ny, dtype=torch.int32, device=device)
    args = (y64, dyws, starts, ok, table, p0, ny_t)
    curve = _fused.prefix_devs_cuda(*args, L=L, measure="mae")
    eps = torch.sort(curve).values[K // 2].reshape(1)
    cap = capture_round(device, name, length=length)
    return [dict(label="random", args=args, eps=eps, mixed=True),
            dict(label=f"real round {cap['round']}", args=cap["args"][:7],
                 eps=cap["args"][7], mixed=False)]


def prefix_bound(K, n_ok, Wy, L, nyb):
    """Bound of one prefix walk, float64.  A rank that is not ok adds a
    zero delta: its output is the committed deviation, so it needs no
    window work and no delta row, only its ok flag and its store.  Bytes:
    y, the ok ranks' delta rows and starts, the ok flags, table + p0, the
    output.  Operations per ok rank: the window-impact count at P = 1,
    plus Wy for the commit of z (the table's commit is a copy)."""
    return bound_ms((nyb + n_ok * Wy + 6 * L + K) * 8 + 4 * n_ok + K,
                    n_ok * (L * (4.0 * Wy + 22) + 6.0 * Wy), FP64_FLOPS)


def prefix_case(device, what: str, args, eps, L: int,
                mixed: bool = True) -> dict:
    """prefix_devs against its plain version on ``args`` (y, dyws, ystarts,
    ok, table, p0, ny): the curve and the greedy walk under mae, rmse and
    cheb too where K is small; one phase-3 entry, timed on the greedy mae
    call, with K and its ok and interior counts.  The greedy walk must
    commit, and skip too where ``mixed``."""
    y, dyws, starts, ok = args[:4]
    K, Wy = dyws.shape
    nyb, ny = y.shape[0], int(args[6].reshape(-1)[0])
    # the plain version walks K candidates with ~30 PyTorch ops each (23 s
    # at aus_elec's K on the card, less than half that on the CPU, whose
    # plain arithmetic is the card's), so it runs once per case, on the
    # card only for the greedy mae call, the one timed
    err, plain_ms = 0.0, None
    cases = [(False, "mae"), (True, "mae")]
    if K <= 4096:
        cases += [(True, "rmse"), (True, "cheb")]
    cpu_args = [a.cpu() for a in args] + [eps.cpu()]
    for greedy, measure in cases:
        kw = dict(L=L, measure=measure, greedy=greedy)
        got = _fused.prefix_devs_cuda(*args, eps, **kw)
        if (greedy, measure) == (True, "mae"):
            want, plain_ms = timed_once(lambda: _fused.prefix_devs_plain(
                *args, eps, **kw), device)
        else:
            want = _fused.prefix_devs_plain(*cpu_args, **kw).to(y.device)
        err = max(err, check_close(
            f"prefix_devs {what} (K={K}, Wy={Wy}, greedy={greedy}, "
            f"{measure})", "prefix_devs", got, want))
    take = ok & (_fused.prefix_devs_cuda(*args, eps, L=L, greedy=True)
                 <= eps)
    require(0 < int(take.sum()) and (int(take.sum()) < int(ok.sum())
                                      or not mixed),
            f"prefix_devs {what}: the greedy walk should commit"
            + (" and skip" if mixed else ""))
    s = torch.clamp(starts.long(), 0, nyb - 1)
    n_ok = int(ok.sum())
    n_int = int((ok & (s >= L) & (s + Wy + L <= ny)).sum())
    kw = dict(L=L, measure="mae", greedy=True)
    bnd, by = prefix_bound(K, n_ok, Wy, L, nyb)
    return dict(
        name="prefix_devs",
        shape=f"{what}: K={K} ok={n_ok} interior={n_int} Wy={Wy} L={L} "
              f"nyb={nyb} float64 greedy (commits {int(take.sum())})",
        K=K, ok=n_ok, interior=n_int, max_abs_err=err,
        ms=device_ms(lambda: _fused.prefix_devs_cuda(*args, eps, **kw),
                     device, reps=5, inner=5),
        plain_ms=plain_ms, library_ms=None, bound_ms=bnd, bound_by=by,
        measures=[m for g, m in cases if g])


# ---------------------------------------------------------------------------
# phase 3, lanes: the four kernels of the rounds path at a batch's shapes
# ---------------------------------------------------------------------------

def lanes_inputs(device, name: str, B: int, length=None):
    """``kernel_inputs`` of B series of ``name`` (seeds 0..B-1), stacked on
    a leading lane axis, with ``ny`` as one int32 value a lane."""
    per = [kernel_inputs(device, name, length, seed=b) for b in range(B)]
    cfg, _, nb, ny = per[0][:4]
    y64, table, p0, dval = (torch.stack([p[i] for p in per])
                            for i in (4, 5, 6, 7))
    ny_t = torch.full((B,), ny, dtype=torch.int32, device=device)
    return cfg, nb, ny, y64, table, p0, dval, ny_t


def require_lanes(what: str, got, one) -> None:
    """Each lane of a batched launch has the bits of its launch alone:
    ``one(b)`` launches lane b by itself."""
    for b in range(got.shape[0]):
        require(torch.equal(got[b], one(b)),
                f"{what}: lane {b} differs from its one-lane launch")


def _lanes_entry(name, shape, err, ms, plain_ms, bound, B, library_ms=None):
    bnd, by = bound
    return dict(name=name, shape=shape, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd,
                bound_by=by, lanes=B)


def phase_kernels_lanes(device, name: str, B: int, length=None,
                        prefix_lanes: int = 0) -> list:
    """lag_dot (self and cross forms), prefix_sum, acf_impact and
    window_rows (and, with ``prefix_lanes``, prefix_devs) on B lanes of
    ``name``'s main-path shapes, one launch for every lane: each against
    its plain version at its tolerance and, lane by lane, against its
    one-lane launch at tolerance 0."""
    cfg, nb, ny, y64, table, p0, dval, ny_t = lanes_inputs(device, name, B,
                                                          length)
    L, kap, nyb = cfg.lags, cfg.kappa, y64.shape[-1]
    out = []

    # lag_dot, float64 self form: [B, nyb] -> [B, L]
    got = _lag_dot.lag_dot_cuda(y64, L=L)
    err = check_close(f"{name} lag_dot B={B}", "lag_dot", got,
                      _lag_dot.lag_dot_plain(y64, L=L))
    require_lanes(f"{name} lag_dot B={B}", got,
                  lambda b: _lag_dot.lag_dot_cuda(y64[b], L=L))
    b_ext = F.pad(y64, (0, L))

    def conv():     # one grouped convolution: lane b's series against itself
        return F.conv1d(b_ext[None, :, 1:], y64[:, None, :],
                        groups=B).view(B, L)
    out.append(_lanes_entry(
        "lag_dot", f"B={B} lanes x n={nyb} L={L} float64", err,
        device_ms(lambda: _lag_dot.lag_dot_cuda(y64, L=L), device),
        device_ms(lambda: _lag_dot.lag_dot_plain(y64, L=L), device,
                  reps=3, inner=3),
        lag_dot_bound(B, nyb, L, torch.float64), B, device_ms(conv, device)))

    # lag_dot's cross form (the partitioned mode's delta contributions):
    # [B, nyb] against b [B, nyb]
    other = torch.flip(y64, (-1,)).contiguous()
    got = _lag_dot.lag_dot_cuda(y64, other, L=L)
    check_close(f"{name} lag_dot B={B} (cross)", "lag_dot", got,
                _lag_dot.lag_dot_plain(y64, other, L=L))
    require_lanes(f"{name} lag_dot B={B} (cross)", got,
                  lambda b: _lag_dot.lag_dot_cuda(
                      y64[b:b + 1], other[b:b + 1], L=L)[0])

    # prefix_sum, the dense update's pair of rows of every lane: [B, 2, nyb]
    out.append(prefix_sum_entry(device, name,
                                torch.stack([y64, y64 * y64], dim=-2), B))
    # dense_sxx, every lane's bilinear term in one launch
    dys = torch.stack([dense_delta(y64[b], ny, seed=b) for b in range(B)])
    out.append(dense_sxx_entry(device, name, y64, dys, ny_t, L, B))

    # acf_impact, the rounds' float32 impacts of every point
    args = (y64.float(), dval.float(), table.float(), p0.float())
    kw = dict(L=L, ny=ny_t, kappa=kap)
    err = 0.0
    for measure in MEASURES:
        got = _acf_impact.acf_impact_cuda(*args, measure=measure, **kw)
        err = max(err, check_close(
            f"{name} acf_impact B={B} ({measure})", "acf_impact", got,
            _acf_impact.acf_impact_plain(*args, measure=measure, **kw)))
        require_lanes(f"{name} acf_impact B={B} ({measure})", got,
                      lambda b: _acf_impact.acf_impact_cuda(
                          *(a[b] for a in args), measure=measure, L=L,
                          ny=ny_t[b:b + 1], kappa=kap))
    out.append(_lanes_entry(
        "acf_impact", f"B={B} lanes x P={nb} nyb={nyb} kappa={kap} L={L} "
                      f"float32", err,
        device_ms(lambda: _acf_impact.acf_impact_cuda(
            *args, measure="mae", **kw), device),
        device_ms(lambda: _acf_impact.acf_impact_plain(
            *args, measure="mae", **kw), device, reps=3, inner=3),
        acf_impact_bound(B, nb, nyb, L, torch.float32), B))

    # window_rows, tiers B and C at the full-size round's capacities, each
    # lane its own candidates
    rng = np.random.default_rng(5)
    scale = float(torch.std(dval.float())) * kap
    W, WB = cfg.window, cameo._TIER_SMALL_W
    tiers = []
    for K, Wx in ((min(nb, max(24, nb // 24)), WB),
                  (min(nb, max(16, nb // 48)), W)):
        Wy = Wx if kap == 1 else Wx // kap + 2
        starts = torch.from_numpy(rng.integers(1, ny - Wy, (B, K)).astype(
            np.int32)).to(device)
        dyws = torch.from_numpy((rng.standard_normal((B, K, Wy)) * scale
                                 ).astype(np.float32)).to(device)
        targs = (y64.float(), dyws, starts, table.float(), ny_t, p0.float())
        err = 0.0
        for measure in MEASURES:
            got = _fused.window_rows_cuda(*targs, L=L, measure=measure)
            err = max(err, check_close(
                f"{name} window_rows B={B} (K={K}, Wy={Wy}, {measure})",
                "window_rows", got,
                _fused.window_rows_plain(*targs, L=L, measure=measure)))
            require_lanes(
                f"{name} window_rows B={B} (K={K}, Wy={Wy}, {measure})", got,
                lambda b: _fused.window_rows_cuda(
                    targs[0][b], dyws[b], starts[b], targs[3][b],
                    ny_t[b:b + 1], targs[5][b], L=L, measure=measure))
        tiers.append(dict(
            K=K, Wy=Wy, err=err,
            ms=device_ms(lambda: _fused.window_rows_cuda(
                *targs, L=L, measure="mae"), device),
            plain_ms=device_ms(lambda: _fused.window_rows_plain(
                *targs, L=L, measure="mae"), device, reps=3, inner=3),
            bound=window_rows_bound(B * K, Wy, L, B * nyb)))
    out.append(_lanes_entry(
        "window_rows", " + ".join(f"B={B} lanes x K={t['K']} Wy={t['Wy']}"
                                  for t in tiers) + f" L={L} float32",
        max(t["err"] for t in tiers),
        *[None if None in v else sum(v) for v in
          ([t["ms"] for t in tiers], [t["plain_ms"] for t in tiers])],
        (sum(t["bound"][0] for t in tiers),
         max(tiers, key=lambda t: t["bound"][0])["bound"][1]), B))

    # prefix_devs, prefix_lanes lanes of the scan's random walk (70% ok,
    # eps at the middle of each lane's prefix curve), one block a lane
    if prefix_lanes:
        Bp = prefix_lanes
        K = max(1, min(int(cfg.alpha * nb), nb - 2))
        Wy = cfg.window if kap == 1 else cfg.window // kap + 2
        sc = float(torch.std(y64[0, :ny])) * 0.05
        rng = np.random.default_rng(6)
        pargs = (y64[:Bp].contiguous(),
                 torch.from_numpy(rng.standard_normal((Bp, K, Wy)) * sc * 0.2
                                  ).to(device),
                 torch.from_numpy(rng.integers(1, ny - Wy, (Bp, K)).astype(
                     np.int32)).to(device),
                 torch.from_numpy(rng.random((Bp, K)) > 0.3).to(device),
                 table[:Bp].contiguous(), p0[:Bp].contiguous(),
                 ny_t[:Bp].contiguous())
        curve = _fused.prefix_devs_cuda(*pargs, L=L, measure="mae")
        eps = torch.sort(curve, dim=-1).values[:, K // 2].contiguous()
        kwp = dict(L=L, measure="mae", greedy=True)
        got = _fused.prefix_devs_cuda(*pargs, eps, **kwp)
        want, plain_ms = timed_once(lambda: _fused.prefix_devs_plain(
            *pargs, eps, **kwp), device)
        err = check_close(f"{name} prefix_devs B={Bp} (greedy, mae)",
                          "prefix_devs", got, want)
        require_lanes(f"{name} prefix_devs B={Bp} (greedy, mae)", got,
                      lambda b: _fused.prefix_devs_cuda(
                          *(a[b] for a in pargs[:6]), ny_t[b:b + 1],
                          eps[b:b + 1], **kwp))
        n_ok = int(pargs[3].sum())
        out.append(_lanes_entry(
            "prefix_devs", f"B={Bp} lanes x random: K={K} ok={n_ok} (all "
                           f"lanes) Wy={Wy} L={L} nyb={nyb} float64 greedy",
            err, device_ms(lambda: _fused.prefix_devs_cuda(
                *pargs, eps, **kwp), device, reps=5, inner=5),
            plain_ms, prefix_bound(Bp * K, n_ok, Wy, L, Bp * nyb), Bp))
    for r in out:
        r["dataset"] = name
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def remeasure(x: np.ndarray, xr: np.ndarray, cfg) -> float:
    """Exact D(S(xr), S(x)) from scratch, float64 on the CPU."""
    transform = _ops._transform_fn(cfg.stat)
    mfn = cameo._measure_fn(cfg)
    stats = []
    for series in (x, xr):
        y = aggregate_series(torch.from_numpy(series), cfg.kappa)
        agg = extract_aggregates(y, cfg.lags, backend="reference")
        stats.append(transform(acf_from_aggregates(agg, y.shape[0])))
    return float(mfn(stats[1], stats[0]))


def check_guarantee(what: str, x: np.ndarray, xr: np.ndarray,
                    kept: np.ndarray, dev: float, cfg) -> float:
    """The guarantee of one compressed series: deviation <= eps, a
    from-scratch float64 re-measure on the CPU agreeing to 1e-9, endpoints
    kept and kept values bit-exact.  Returns the re-measure."""
    require(dev <= cfg.eps + 1e-12, f"{what}: deviation {dev} > eps")
    re = remeasure(x, xr, cfg)
    require(abs(re - dev) <= 1e-9,
            f"{what}: re-measured deviation {re} != reported {dev}")
    require(bool(kept[0] and kept[-1]), f"{what}: an endpoint was dropped")
    require(np.array_equal(xr[kept], x[kept]),
            f"{what}: kept values are not bit-exact")
    return re


def _path_cfg(name: str, path: str):
    over, kernels, held = PATHS[path]
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name), **over)
    return cfg, kernels, held


def first_differing_pop(device, cfg, x: np.ndarray) -> dict:
    """Step the sequential loop on the card and on the CPU side by side
    from their own inits and report the first pop whose kept masks differ:
    the point each removed and their popped impacts."""
    out = None
    states = []
    for dev in (torch.device(device), torch.device("cpu")):
        xt = torch.from_numpy(x).to(dev)
        carry, p0 = cameo._sequential_init(xt, cfg)
        states.append([carry, *cameo._sequential_fns(cfg, x.shape[0], p0)])
    pop = 0
    while bool(states[1][1](states[1][0])):
        pops = []
        for st in states:
            carry, _, body = st
            i = int(torch.argmin(carry[4]))
            pops.append(dict(point=i, impact=float(carry[4][i])))
            st[0] = body(carry)
        if not torch.equal(states[0][0][1].cpu(), states[1][0][1]):
            out = dict(pop=pop, card=pops[0], cpu=pops[1])
            break
        pop += 1
    return out or dict(pop=None, pops=pop)


def _main_series(name: str, path: str, length):
    cfg, kernels, held = _path_cfg(name, path)
    x = make_dataset(name, seed=0, length=length)
    return cfg, kernels, held, x[:(x.shape[0] // cfg.kappa) * cfg.kappa]


def cpu_reference(name: str, path: str, length=None) -> dict:
    """The CPU path's run of ``phase_main``'s (name, path, length): its
    kept mask, kept count, iterations and wall seconds."""
    cfg, _, _, x = _main_series(name, path, length)
    t0 = time.perf_counter()
    ref = cameo.compress(x, cfg, device="cpu")
    return dict(kept=ref.kept.numpy(), n_kept=int(ref.n_kept),
                iters=int(ref.iters), deviation=float(ref.deviation),
                wall_s=time.perf_counter() - t0)


def _cpu_worker_init(threads: int) -> None:
    torch.set_num_threads(threads)


def cpu_references(jobs) -> tuple:
    """Start :func:`cpu_reference` of each (name, path, length) in ``jobs``
    in ``CPU_REF_WORKERS`` spawned processes; ``(pool, {(name, path):
    future})``.  The caller shuts the pool down."""
    pool = concurrent.futures.ProcessPoolExecutor(
        CPU_REF_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init, initargs=(CPU_REF_THREADS,))
    return pool, {(name, path): pool.submit(cpu_reference, name, path, length)
                  for name, path, length in jobs}


def phase_main(device, name: str, path: str = "rounds", length=None,
               cpu_check: bool = True, cpu_ref=None):
    """``compress`` of ``name`` by ``path`` on ``device`` with its guarantee
    and kernels held; on the card, against the CPU path's run
    (``cpu_ref``, a future of :func:`cpu_reference`, or run here)."""
    cfg, kernels, held, x = _main_series(name, path, length)
    n = x.shape[0]
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = cameo.compress(x, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else None

    kept = res.kept.cpu().numpy()
    xr = res.xr.cpu().numpy()
    dev = float(res.deviation)
    what = f"{name} {path}"
    re = check_guarantee(what, x, xr, kept, dev, cfg)
    if device.type == "cuda":
        for kname in kernels:
            require(counts[kname] > 0,
                    f"{what}: kernel {kname} was never launched")
    cr = n / float(kept.sum())
    row = dict(dataset=name, path=path, n=n, lags=cfg.lags, kappa=cfg.kappa,
               iters=int(res.iters), cr=cr, deviation=dev, remeasured=re,
               wall_s=wall, s_per_iter=wall / max(int(res.iters), 1),
               launches=counts, launches_per_iter=sum(counts.values())
               / max(int(res.iters), 1), max_memory_allocated=mem)
    if cpu_check and device.type == "cuda":
        ref = cpu_ref.result() if cpu_ref is not None \
            else cpu_reference(name, path, length)
        row.update(cr_cpu=n / float(ref["n_kept"]), iters_cpu=ref["iters"],
                   wall_s_cpu=ref["wall_s"],
                   same_kept=bool(np.array_equal(kept, ref["kept"])),
                   deviation_bits_equal=dev.hex() == ref["deviation"].hex())
        if path == "rounds":
            # the round body's sums all take the CPU path's order (C16)
            require(row["same_kept"] and row["deviation_bits_equal"]
                    and row["iters"] == ref["iters"],
                    f"{what}: the card's run parts from the CPU path's "
                    f"(kept {row['same_kept']}, iterations {row['iters']} / "
                    f"{ref['iters']}, deviation {dev!r} / "
                    f"{ref['deviation']!r})")
        if held:
            require(abs(cr - row["cr_cpu"]) <= 0.05 * row["cr_cpu"],
                    f"{what}: CR {cr} is not within 5% of the CPU path's "
                    f"{row['cr_cpu']}")
        if path == "sequential" and not row["same_kept"]:
            row["first_differing_pop"] = first_differing_pop(device, cfg, x)
    return row


# ---------------------------------------------------------------------------
# phase 4, batch: compress_batch and compress_multivariate
# ---------------------------------------------------------------------------

def batch_series(name: str, B: int, length=None) -> np.ndarray:
    """B series of dataset ``name`` (seeds 0..B-1) at full width, ``[B,
    n]``, trimmed to a multiple of kappa."""
    kap = dataset_cameo_kwargs(name).get("kappa", 1)
    xs = np.stack([make_dataset(name, seed=b, length=length)
                   for b in range(B)])
    return xs[:, :(xs.shape[1] // kap) * kap]


def _run_timed(fn, device):
    """(fn(), wall s, peak device memory) on a quiet card."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    return out, wall, mem


def phase_batch(device, name: str, B: int, held: bool, length=None) -> dict:
    """``compress_batch`` of B series of ``name`` on ``device``: every lane
    passes the guarantee checks, the round launches each kernel of the
    rounds path at most once a lane group (two groups), and, where
    ``held``, each lane equals its per-series ``compress_rounds`` run on the
    same device (kept mask, iterations and the deviation's bits)."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    xs = batch_series(name, B, length)
    n = xs.shape[1]
    reset_counts()
    res, wall, mem = _run_timed(
        lambda: cameo.compress_batch(xs, cfg, device=device), device)
    counts = read_counts()
    kept, xr = res.kept.cpu().numpy(), res.xr.cpu().numpy()
    devs, iters = res.deviation.cpu().numpy(), res.iters.cpu().numpy()
    what = f"{name} batch B={B}"
    for b in range(B):
        check_guarantee(f"{what} lane {b}", xs[b], xr[b], kept[b],
                        float(devs[b]), cfg)
    rounds = int(iters.max())
    per_round = {k: c / max(rounds, 1) for k, c in counts.items()}
    if device.type == "cuda":
        for kname in PATHS["rounds"][1]:
            require(counts[kname] > 0,
                    f"{what}: kernel {kname} was never launched")
        require(per_round["acf_impact"] <= 2
                and per_round["window_rows"] <= 2 * TIERS,
                f"{what}: {per_round['acf_impact']} acf_impact and "
                f"{per_round['window_rows']} window_rows launches a round, "
                f"more than the two lane groups' 2 and {2 * TIERS}")
    row = dict(dataset=name, B=B, n=n, lags=cfg.lags, kappa=cfg.kappa,
               rounds=rounds, iters_min=int(iters.min()),
               cr_mean=float(np.mean(n / kept.sum(axis=1))),
               max_deviation=float(devs.max()), wall_s=wall,
               launches=counts, launches_per_round=per_round,
               max_memory_allocated=mem)
    if held:
        loop_s, dev_equal = 0.0, 0
        for b in range(B):
            one, s_b, _ = _run_timed(
                lambda: cameo.compress_rounds(xs[b], cfg, device=device),
                device)
            loop_s += s_b
            require(np.array_equal(one.kept.cpu().numpy(), kept[b])
                    and int(one.iters) == int(iters[b])
                    and float(one.deviation) == float(devs[b]),
                    f"{what}: lane {b} parts from its per-series run "
                    f"({int(iters[b])} rounds against {int(one.iters)}, "
                    f"deviation {float(devs[b])!r} against "
                    f"{float(one.deviation)!r})")
        row.update(loop_wall_s=loop_s, lanes_held=B)
    return row


def phase_multivariate(device, name: str = "uk_elec", C: int = MV_COLUMNS,
                       length=None) -> dict:
    """``compress_multivariate`` of ``X [n, C]`` (C series of ``name`` as
    columns): every column passes the guarantee checks on the shared
    index."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    X = np.ascontiguousarray(batch_series(name, C, length).T)
    reset_counts()
    res, wall, mem = _run_timed(
        lambda: cameo.compress_multivariate(X, cfg, device=device), device)
    counts = read_counts()
    for c in range(C):
        check_guarantee(f"{name} multivariate column {c}", X[:, c],
                        res.xr[:, c], res.kept, float(res.deviations[c]),
                        cfg)
    if device.type == "cuda":
        for kname in PATHS["rounds"][1]:
            require(counts[kname] > 0, f"{name} multivariate: kernel "
                                       f"{kname} was never launched")
    return dict(dataset=name, C=C, n=X.shape[0], iters=res.iters,
                n_kept=res.n_kept, cr=X.shape[0] / res.n_kept,
                col_n_kept=res.col_n_kept.tolist(),
                deviations=res.deviations.tolist(), wall_s=wall,
                launches=counts, max_memory_allocated=mem)


# ---------------------------------------------------------------------------
# phase 4, streaming: StreamingCompressor / MVStreamingCompressor into a store
# ---------------------------------------------------------------------------

def stream_chunks(n: int, seed: int = 0):
    """Seeded chunk borders of a feed of ``n`` points (1-3,000 points a
    chunk)."""
    rng = np.random.default_rng(seed)
    cuts, at = [], 0
    while True:
        at += int(rng.integers(STREAM_CHUNKS[0], STREAM_CHUNKS[1] + 1))
        if at >= n:
            return cuts
        cuts.append(at)


def _feed(sc, chunks, sess=None, stop_after=None):
    """Push ``chunks`` (then finish, unless stopped after chunk
    ``stop_after``); every closed window goes to ``sess`` too.  Returns
    the windows."""
    wins = []
    for i, chunk in enumerate(chunks):
        got = sc.push(chunk)
        wins += got
        if sess is not None:
            sess.append_windows(got)
        if i == stop_after:
            return wins
    got = sc.finish()
    if sess is not None:
        sess.append_windows(got)
    return wins + got


def _concat(wins, field):
    return np.concatenate([getattr(w, field) for w in wins])


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _count_batches(module=streaming):
    """Count ``compress_batch`` calls made by ``module`` (the streaming
    module: a drain of several windows is one; the façade: a
    ``write_batch`` group is one)."""
    calls = [0]
    real = module.compress_batch

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    module.compress_batch = counted
    return calls, lambda: setattr(module, "compress_batch", real)


def _stream_store(device, tmp: Path, tag: str, cfg, wins, channels=1):
    """The windows written through ``open_stream`` into a port store;
    returns (file bytes, decoded series)."""
    path = str(tmp / f"{tag}.cameo")
    with CameoStore.create(path, version=4, device=device) as st:
        sess = st.open_stream("s", cfg, channels=channels)
        sess.append_windows(wins)
        if channels == 1:
            sess.close()
        else:
            sess.close(deviations=[0.0] * channels)
    with CameoStore.open(path, device=device) as st:
        decoded = st.read_series("s")
    return Path(path).read_bytes(), decoded


def phase_stream(device, case: str, name: str, n: int, W: int, depths,
                 one_chunk: bool, tmp: Path, cpu_check: bool = True) -> dict:
    """One univariate stream at full width: the seeded feed at each queue
    depth (and, with ``one_chunk``, as one chunk), held window for window (kept masks and ``xr``
    bits equal across chunkings and depths; each full window equal to
    ``compress()`` of its slice on the same device; every compressed
    window within eps by a float64 re-measure; the stream's ``deviation()``
    within 1e-9 of a from-scratch measure; a mid-stream ``state_dict``
    resumed to the same bits; the windows written into a store read back
    bit-equal, and the file's bytes equal between the depths)."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=0)[:n]
    chunks = np.split(x, stream_chunks(n))
    what = f"stream {case}"
    runs = {}
    batches, restore = _count_batches()
    try:
        for qd in depths:
            reset_counts()
            _lag_dot.lag_dot_cuda.halo_launches = 0
            batches[0] = 0
            sc = streaming.StreamingCompressor(cfg, W, queue_depth=qd,
                                               device=device)
            wins, wall, mem = _run_timed(lambda: _feed(sc, chunks), device)
            runs[qd] = dict(wins=wins, wall_s=wall, mem=mem,
                            deviation=sc.deviation(),
                            launches=read_counts(),
                            halo_launches=_lag_dot.lag_dot_cuda.halo_launches,
                            batch_calls=batches[0])
    finally:
        restore()
    first = runs[depths[0]]
    kept, xr = _concat(first["wins"], "kept"), _concat(first["wins"], "xr")
    for qd, r in runs.items():
        require(_bits(_concat(r["wins"], "kept")) == _bits(kept)
                and _bits(_concat(r["wins"], "xr")) == _bits(xr),
                f"{what}: queue depth {qd} gives other windows than "
                f"{depths[0]}")
        require(r["deviation"] == first["deviation"],
                f"{what}: queue depth {qd} gives another deviation")
    if one_chunk:
        one = streaming._compress_windowed(x, cfg, W, device=device)
        require(_bits(one.kept.cpu().numpy()) == _bits(kept)
                and _bits(one.xr.cpu().numpy()) == _bits(xr),
                f"{what}: one chunk gives other windows than the chunked "
                f"feed")
    if device.type == "cuda":
        for kname in PATHS["rounds"][1]:
            require(first["launches"][kname] > 0,
                    f"{what}: kernel {kname} was never launched")
        require(first["halo_launches"] > 0,
                f"{what}: lag_dot's halo form was never launched")
    # window by window: the guarantee, and full windows against compress()
    full = 0
    for w in first["wins"]:
        m = w.x.shape[0]
        ndiv = (m // cfg.kappa) * cfg.kappa
        if w.iters == 0:          # kept verbatim
            require(bool(w.kept.all()), f"{what}: a verbatim window dropped "
                                        f"a point")
            continue
        re = remeasure(w.x[:ndiv], w.xr[:ndiv], cfg)
        require(re <= cfg.eps + 1e-9,
                f"{what}: window at {w.start} re-measures {re} > eps")
        require(bool(w.kept[0] and w.kept[-1])
                and np.array_equal(w.xr[w.kept], w.x[w.kept]),
                f"{what}: window at {w.start} lost an endpoint or a kept "
                f"value's bits")
        if m == W:
            full += 1
            res = cameo.compress(w.x, cfg, device=device)
            require(_bits(res.kept.cpu().numpy()) == _bits(w.kept)
                    and _bits(res.xr.cpu().numpy()) == _bits(w.xr),
                    f"{what}: window at {w.start} differs from compress() "
                    f"of its slice")
            require(abs(float(res.deviation) - re) <= 1e-9,
                    f"{what}: window at {w.start}: compress() reports "
                    f"{float(res.deviation)}, re-measured {re}")
    nd = (n // cfg.kappa) * cfg.kappa
    re_all = remeasure(x[:nd], xr[:nd], cfg)
    require(abs(re_all - first["deviation"]) <= 1e-9,
            f"{what}: the stream's deviation {first['deviation']} is not "
            f"within 1e-9 of its re-measure {re_all}")
    # a pause mid-stream: state_dict through JSON, resumed on the card
    qd = depths[-1]
    sc = streaming.StreamingCompressor(cfg, W, queue_depth=qd, device=device)
    k = len(chunks) // 2
    before = _feed(sc, chunks, stop_after=k)
    state = json.loads(json.dumps(sc.state_dict()))
    sc = streaming.compressor_from_state(cfg, state, device=device)
    after = _feed(sc, chunks[k + 1:])
    require(_bits(_concat(before + after, "kept")) == _bits(kept)
            and _bits(_concat(before + after, "xr")) == _bits(xr)
            and sc.deviation() == first["deviation"],
            f"{what}: the stream resumed from its state_dict parts from "
            f"the uninterrupted one")
    # into the store, at each depth
    files = {}
    for qd, r in runs.items():
        files[qd], decoded = _stream_store(device, tmp, f"{case}-{qd}", cfg,
                                           r["wins"])
        require(_bits(decoded) == _bits(xr),
                f"{what}: the store decodes other bits than the stream's xr "
                f"(queue depth {qd})")
    require(len(set(files.values())) == 1,
            f"{what}: the store files differ between queue depths")
    n_windows = len(first["wins"])
    row = dict(case=case, dataset=name, n=n, window=W, lags=cfg.lags,
               kappa=cfg.kappa, windows=n_windows, full_windows=full,
               chunks=len(chunks), tail=first["wins"][-1].x.shape[0],
               tail_iters=first["wins"][-1].iters,
               n_kept=int(kept.sum()), cr=n / float(kept.sum()),
               deviation=first["deviation"], remeasured=re_all,
               store_bytes=len(files[depths[0]]),
               depths={str(qd): dict(
                   wall_s=r["wall_s"], points_per_s=n / r["wall_s"],
                   batch_calls=r["batch_calls"],
                   lag_dot_halo_launches=r["halo_launches"],
                   launches=r["launches"], max_memory_allocated=r["mem"])
                   for qd, r in runs.items()})
    if cpu_check and device.type == "cuda":
        t0 = time.perf_counter()
        sc = streaming.StreamingCompressor(cfg, W, device="cpu")
        cpu = _feed(sc, chunks)
        cpu_kept = _concat(cpu, "kept")
        same = sum(bool(np.array_equal(a.kept, b.kept))
                   for a, b in zip(first["wins"], cpu))
        row.update(cr_cpu=n / float(cpu_kept.sum()), wall_s_cpu=(
            time.perf_counter() - t0), windows_same_kept_as_cpu=same,
                   iters=[w.iters for w in first["wins"]],
                   iters_cpu=[w.iters for w in cpu])
        require(abs(row["cr"] - row["cr_cpu"]) <= 0.05 * row["cr_cpu"],
                f"{what}: CR {row['cr']} is not within 5% of the CPU "
                f"path's {row['cr_cpu']}")
    return row


def phase_stream_mv(device, tmp: Path, C: int = STREAM_MV_COLUMNS,
                    n: int = 17520, W: int = 4096) -> dict:
    """``MVStreamingCompressor`` of uk_elec-shaped ``[n, C]`` (seeds as
    columns): the seeded feed against one chunk (kept mask and ``xr``
    bits), every column of every compressed window within eps by a
    float64 re-measure, ``deviations()`` within 1e-9 of each column's
    from-scratch measure, and the windows through a store read back
    bit-equal."""
    name = "uk_elec"
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    X = np.ascontiguousarray(batch_series(name, C, n).T)
    chunks = np.split(X, stream_chunks(n, seed=1))
    reset_counts()
    sc = streaming.MVStreamingCompressor(cfg, W, C, device=device)
    wins, wall, mem = _run_timed(lambda: _feed(sc, chunks), device)
    counts = read_counts()
    one = streaming.compress_windowed_mv(X, cfg, W, device=device)
    kept, xr = _concat(wins, "kept"), _concat(wins, "xr")
    what = f"stream multivariate [{n}, {C}]"
    require(_bits(one.kept) == _bits(kept) and _bits(one.xr) == _bits(xr),
            f"{what}: one chunk gives other windows than the chunked feed")
    for w in wins:
        if w.iters == 0:
            continue
        for c in range(C):
            re = remeasure(w.x[:, c], w.xr[:, c], cfg)
            require(re <= cfg.eps + 1e-9, f"{what}: window at {w.start} "
                                          f"column {c} re-measures {re}")
    devs = sc.deviations()
    for c in range(C):
        re = remeasure(X[:, c], xr[:, c], cfg)
        require(abs(re - devs[c]) <= 1e-9, f"{what}: column {c}'s deviation "
                                           f"{devs[c]} against {re}")
    data, decoded = _stream_store(device, tmp, "mv", cfg, wins, channels=C)
    require(_bits(decoded) == _bits(xr),
            f"{what}: the store decodes other bits than the stream's xr")
    if device.type == "cuda":
        for kname in PATHS["rounds"][1]:
            require(counts[kname] > 0,
                    f"{what}: kernel {kname} was never launched")
    return dict(case="multivariate", dataset=name, n=n, C=C, window=W,
                windows=len(wins), n_kept=int(kept.sum()),
                cr=n / float(kept.sum()), deviations=devs.tolist(),
                wall_s=wall, points_per_s=n * C / wall, launches=counts,
                store_bytes=len(data), max_memory_allocated=mem)


def run_streams(device, *, streams=STREAMS, mv=(STREAM_MV_COLUMNS, 17520,
                                                4096),
                cpu_check: bool = True, log=print) -> dict:
    """The streaming phase: each of ``streams`` and the multivariate
    stream (``mv``: columns, points, window; None to skip), with the
    telemetry registry on (it changes no result) and the build watermark
    held flat.  Returns the rows and the registry's stream counters."""
    import tempfile
    device = torch.device(device)
    was = obs.enabled()
    obs.reset()
    obs.enable()
    mark = obs.recompile_watermark()
    rows = []
    (ROOT / "build").mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            for case, name, n, W, depths, one_chunk in streams:
                row = phase_stream(device, case, name, n, W, depths,
                                   one_chunk, Path(tmp), cpu_check=cpu_check)
                rows.append(row)
                log("stream " + json.dumps(row))
            if mv:
                row = phase_stream_mv(device, Path(tmp), *mv)
                rows.append(row)
                log("stream " + json.dumps(row))
        snap = obs.snapshot()
    finally:
        obs.OBS.enabled = was
    require(obs.recompile_watermark() == mark,
            f"stream: the build watermark moved ({mark} -> "
            f"{obs.recompile_watermark()}): a kernel was built mid-stream")
    counters = {k: v for k, v in snap["counters"].items()
                if k.startswith(("stream.", "cameo."))}
    return dict(rows=rows, counters=counters, watermark=mark)


# ---------------------------------------------------------------------------
# the facade phase: api/, server/ and serving/ts_service.py
# ---------------------------------------------------------------------------

# the facade phase's sizes: the datasets' full lengths, write_batch's B and
# the lanes held against solo writes, the multivariate columns, the
# sequential write's length (it pops one point at a time, a few ms each on
# the card), the server's sessions (uk_elec stand-ins, seeds 0..3, the first
# two on the default tenant, the others on "acme") and the service's
# submits
FACADE = dict(uk_n=17520, aus_n=230688, batch_B=16, batch_held=(0, 7, 15),
              mv_C=4, seq_n=1024, server_n=17520, sessions=4,
              service_B=8, query=(1000, 16000))
SERVER_PLAN = (("", "m0"), ("", "m1"), ("acme", "m2"), ("acme", "m3"))


def _series_facts(store, sid: str):
    """One series as stored, wherever it lies in its file: its block
    bodies, their spans and sizes, and its catalog entry but the blocks'
    offsets."""
    entry = store.series_meta(sid)
    bodies = [bytes(b) for b in store._read_bodies(entry["blocks"])]
    blocks = [(b["nbytes"], b["t0"], b["t1"]) for b in entry["blocks"]]
    rest = {k: v for k, v in entry.items() if k != "blocks"}
    return bodies, blocks, json.dumps(rest, sort_keys=True, default=str)


def _query_holds(what: str, s, x: np.ndarray, a: int, b: int, L: int):
    """The pushdown answers over ``[a, b)`` against the exact statistics:
    mean and variance of the original series (the store keeps residual
    moments), ACF and PACF of the decoded window, each within its bound.
    Returns the answers' largest error over bound."""
    xr = s.window(a, b)
    r_exact = acf(torch.from_numpy(np.ascontiguousarray(xr)), L)
    exact = dict(mean=x[a:b].mean(), var=x[a:b].var(), acf=r_exact.numpy(),
                 pacf=pacf_from_acf(r_exact).numpy())
    worst = 0.0
    for kind, want in exact.items():
        v, bound = getattr(s, kind)(a, b)
        err = np.abs(np.asarray(v) - want)
        require(bool(np.all(err <= bound)),
                f"{what}: {kind} over [{a}, {b}) is off by {err.max()} "
                f"against a bound of {np.min(bound)}")
        worst = max(worst, float(np.max(err / np.maximum(bound, 1e-300))))
    return worst


def _serve(device, path: Path, cfg, feeds, n: int, quota: int,
           concurrent: bool):
    """The server's sessions (``SERVER_PLAN``), their feeds in seeded
    chunks, one after another or from one host thread each at once; then
    the background compaction drained.  Returns (server, wall s, pushes)."""
    from repro_torch.server import IngestServer, ServerConfig
    srv = IngestServer(str(path), cfg,
                       ServerConfig(seal_block_len=512, auto_compact=True),
                       device=device)
    srv.register_tenant("acme", eps=5e-2, max_points=quota)
    chunks = [np.split(feeds[i], stream_chunks(n, seed=i))
              for i in range(len(SERVER_PLAN))]
    start = threading.Barrier(len(SERVER_PLAN)) if concurrent else None
    errors = []

    def feed(i):
        tenant, series = SERVER_PLAN[i]
        try:
            if start is not None:
                start.wait(timeout=60)
            with srv.session(series, tenant=tenant) as sess:
                for c in chunks[i]:
                    sess.push(c)
        except Exception as e:       # noqa: BLE001 — reported below
            errors.append(f"{tenant}/{series}: {e!r}")

    def run():
        if not concurrent:
            for i in range(len(SERVER_PLAN)):
                feed(i)
        else:
            threads = [threading.Thread(target=feed, args=(i,))
                       for i in range(len(SERVER_PLAN))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            require(not any(t.is_alive() for t in threads),
                    "server: a producer thread hung")
        srv.drain_compaction()

    _, wall, _ = _run_timed(run, torch.device(device))
    require(not errors, f"server: a session failed: {errors}")
    return srv, wall, sum(len(c) for c in chunks)


def phase_facade(device, tmp: Path, sizes=None, log=print) -> dict:
    """The port's facade on ``device`` at full width (``FACADE``), with the
    telemetry registry on: ``api.open(...).write`` of uk_elec and aus_elec
    (their bytes equal ``CameoStore.append_series`` of ``compress()``),
    the pushdown answers' bounds, ``write_batch`` (one ``compress_batch``;
    held lanes equal solo writes), a multivariate write, a scan and a
    sequential write; the ingest server's sessions from one host thread
    each, held to the same sessions run one after another (every series'
    blocks and entry), its quota refusal before the journal, its counters,
    its compaction and a ``resume=True`` reopen answering the same; the
    service shim's submits equal to ``write_batch``.  Every kernel is
    launched in the phase (on the card).  Returns the steps."""
    from repro_torch import api
    from repro_torch.server import QuotaExceeded, tenant_sid
    from repro_torch.serving.ts_service import (TimeSeriesService,
                                                TsServiceConfig)
    device = torch.device(device)
    z = dict(FACADE, **(sizes or {}))
    a, b = z["query"]
    steps = {}

    def step(key, n, wall, path=None, **holds):
        steps[key] = dict(n=n, wall_s=wall, points_per_s=n / wall,
                          file_bytes=Path(path).stat().st_size
                          if path else None, **holds)
        log(f"facade step {key} " + json.dumps(steps[key]))

    uk = _path_cfg("uk_elec", "rounds")[0]
    reset_counts()
    # one-shot writes at full width, held to the store path they replace
    for name, n in (("uk_elec", z["uk_n"]), ("aus_elec", z["aus_n"])):
        cfg = _path_cfg(name, "rounds")[0]
        x = batch_series(name, 1, n)[0]
        path = tmp / f"write_{name}.cameo"

        def write():
            with api.open(str(path), cfg, mode="w", device=device) as ds:
                return ds.write(name, x)

        entry, wall, _ = _run_timed(write, device)
        ref = tmp / f"append_{name}.cameo"
        with CameoStore.create(str(ref), device=device) as st:
            st.append_series(name, cameo.compress(x, cfg, device=device),
                             cfg, x=x)
        require(path.read_bytes() == ref.read_bytes(),
                f"facade: write {name} stores other bytes than "
                "append_series of compress()")
        worst = None
        if name == "uk_elec":
            with api.open(str(path), device=device) as ds:
                worst = _query_holds(f"facade {name}", ds.series(name), x,
                                     a, min(b, n - 1), cfg.lags)
        step(f"write {name}", x.shape[0], wall, path,
             cr=x.shape[0] / entry["n_kept"], deviation=entry["deviation"],
             bytes_equal_append=True, query_err_over_bound=worst)
    # write_batch: one compress_batch, held lanes equal solo writes
    xs = batch_series("uk_elec", z["batch_B"], z["uk_n"])
    items = {f"b{i}": xs[i] for i in range(xs.shape[0])}
    path = tmp / "batch.cameo"

    def write_batch():
        with api.open(str(path), uk, mode="w", device=device) as ds:
            return ds.write_batch(items)

    calls, restore = _count_batches(api.dataset)
    try:
        _, wall, _ = _run_timed(write_batch, device)
    finally:
        restore()
    require(calls[0] == 1, f"facade: write_batch made {calls[0]} "
                           "compress_batch calls, not one")
    solo = tmp / "solo.cameo"
    held = [f"b{i}" for i in z["batch_held"] if i < xs.shape[0]]
    with api.open(str(solo), uk, mode="w", device=device) as ds:
        for sid in held:
            ds.write(sid, items[sid])
    with CameoStore.open(str(path), device=device) as sa, \
            CameoStore.open(str(solo), device=device) as sb:
        for sid in held:
            require(_series_facts(sa, sid) == _series_facts(sb, sid),
                    f"facade: write_batch lane {sid} is not its solo write")
    step("write_batch uk_elec", xs.size, wall, path, B=xs.shape[0],
         compress_batch_calls=calls[0], lanes_equal_solo=len(held))
    # a multivariate series, a scan and a sequential write
    X = np.ascontiguousarray(batch_series("uk_elec", z["mv_C"], z["uk_n"]).T)
    path = tmp / "mv.cameo"

    def write_mv():
        with api.open(str(path), uk, mode="w", device=device) as ds:
            return ds.write("mv", X)

    entry, wall, _ = _run_timed(write_mv, device)
    with api.open(str(path), device=device) as ds:
        s = ds.series("mv")
        xr = s.window()
        idx, _ = s.kept()
    require(xr.shape == X.shape and np.array_equal(xr[idx], X[idx]),
            "facade: the multivariate series decodes other kept values")
    require(max(entry["deviations"]) <= uk.eps + 1e-12,
            f"facade: multivariate deviations {entry['deviations']} > eps")
    step("write multivariate", X.size, wall, path, C=X.shape[1],
         deviations=list(entry["deviations"]), cr=X.shape[0] / len(idx))
    for kind, n in (("scan", z["uk_n"]), ("sequential", z["seq_n"])):
        cfg = _path_cfg("uk_elec", kind)[0]
        x = batch_series("uk_elec", 1, n)[0]
        path = tmp / f"{kind}.cameo"

        def write_kind():
            with api.open(str(path), cfg, mode="w", device=device) as ds:
                return ds.write(kind, x)

        entry, wall, _ = _run_timed(write_kind, device)
        with api.open(str(path), device=device) as ds:
            s = ds.series(kind)
            kept = np.zeros(n, bool)
            kept[s.kept()[0]] = True
            check_guarantee(f"facade {kind}", x, s.window(), kept,
                            entry["deviation"], cfg)
        step(f"write {kind} uk_elec", n, wall, path,
             cr=n / entry["n_kept"], deviation=entry["deviation"])
    # the ingest server: four sessions from four host threads, against the
    # same sessions one after another
    n = z["server_n"]
    feeds = batch_series("uk_elec", len(SERVER_PLAN), n)
    quota = 2 * n
    serial, wall_serial, _ = _serve(device, tmp / "serial.cameo", uk, feeds,
                                    n, quota, concurrent=False)
    want = {sid: _series_facts(serial.store, sid)
            for sid in serial.store.series_ids()}
    serial.close()
    was = obs.enabled()
    obs.reset()
    obs.enable()
    try:
        path = tmp / "server.cameo"
        srv, wall, pushes = _serve(device, path, uk, feeds, n, quota,
                                   concurrent=True)
        sids = [tenant_sid(t, s) for t, s in SERVER_PLAN]
        require(sorted(srv.store.series_ids()) == sorted(want) ==
                sorted(sids), "facade: the servers hold other series")
        for sid in sids:
            require(_series_facts(srv.store, sid) == want[sid],
                    f"facade: server series {sid} differs from the "
                    "sessions run one after another")
        # the quota: refused before the journal
        extra = srv.session("extra", tenant="acme")
        wal = Path(srv.store._wal.path)
        size = wal.stat().st_size
        try:
            extra.push(feeds[0][:1])
            require(False, "facade: an over-quota push was accepted")
        except QuotaExceeded:
            pass
        require(wal.stat().st_size == size and extra.n_seen == 0,
                "facade: the over-quota push reached the journal")
        st = srv.stats()
        text = srv.metrics_text()
        require(st["tenants"]["acme"]["points"] == quota
                and st["tenants"][""]["points"] == 2 * n,
                f"facade: tenant usage {st['tenants']}")
        require(st["compaction"]["compacted"] == len(SERVER_PLAN)
                and st["compaction"]["last_error"] is None,
                f"facade: compaction {st['compaction']}")
        for line in (f"cameo_server_points_total {len(SERVER_PLAN) * n}",
                     f"cameo_server_pushes_total {pushes}",
                     f'cameo_server_tenant_points_total{{tenant="acme"}} '
                     f'{quota}'):
            require(line in text, f"facade: /metrics lacks {line!r}")
        answers = _server_answers(srv, a, b)
        srv.close()
    finally:
        snap = obs.snapshot()
        obs.OBS.enabled = was
    from repro_torch.server import IngestServer, ServerConfig
    again = IngestServer(str(path), uk,
                         ServerConfig(seal_block_len=512, auto_compact=True),
                         resume=True, device=device)
    require(_server_answers(again, a, b) == answers,
            "facade: the server answers otherwise after a resume=True "
            "reopen")
    again.close()
    step("server 4 threads", len(SERVER_PLAN) * n, wall, path,
         serial_wall_s=wall_serial, series_equal_serial=len(sids),
         pushes=pushes, quota_refused_before_journal=True,
         compacted=st["compaction"]["compacted"],
         counters={k: v for k, v in snap["counters"].items()
                   if k.startswith("server.")}, resumed_answers_equal=True)
    # the deprecated service shim against write_batch
    xs = batch_series("uk_elec", z["service_B"], z["uk_n"])
    items = {f"v{i}": xs[i] for i in range(xs.shape[0])}
    path = tmp / "service.cameo"

    def service():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with TimeSeriesService(str(path), uk, TsServiceConfig(),
                                   device=device) as svc:
                for sid, x in items.items():
                    svc.submit(sid, x)
                svc.flush()

    _, wall, _ = _run_timed(service, device)
    ref = tmp / "service_ref.cameo"
    with api.open(str(ref), uk, mode="w", device=device) as ds:
        ds.write_batch(items)
    require(path.read_bytes() == ref.read_bytes(),
            "facade: the service's submits store other bytes than "
            "write_batch")
    step(f"service {xs.shape[0]} submits", xs.size, wall, path,
         bytes_equal_batch=True)
    counts = read_counts()
    if device.type == "cuda":
        # every compress path runs here; segment_scan serves the baselines,
        # and no path launches cell_sum (segment_cells sums the cells)
        for kname in WRAPPERS:
            require(counts[kname] > 0 or kname in ("segment_scan",
                                                   "cell_sum"),
                    f"facade: kernel {kname} was never launched")
    return dict(steps=steps, launches=counts)


def _server_answers(srv, a: int, b: int) -> dict:
    """Each session's series' mean and ACF over ``[a, b)`` with their
    bounds, as bytes."""
    return {(t, s): [np.asarray(v).tobytes() for kind in ("mean", "acf")
                     for v in getattr(srv.series(s, tenant=t), kind)(a, b)]
            for t, s in SERVER_PLAN}


def run_facade(device, sizes=None, log=print) -> dict:
    """The facade phase in a temporary directory under ``build/``."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = phase_facade(device, Path(tmp), sizes, log=log)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the partitioned phase (core/parallel.py, compress_batch(mesh=))
# ---------------------------------------------------------------------------

PART_FIELDS = ("kept", "xr", "deviation", "n_kept", "iters", "stat_orig",
               "stat_new")


def _same_result(a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in PART_FIELDS)


def _part_row(device, what: str, name: str, x: np.ndarray, cfg, fn,
              guarantee: bool = True) -> tuple:
    """Run ``fn()`` timed with the counts set to 0 just before and read just
    after; hold its guarantee (or, ``guarantee=False``, its re-measure and
    kept values only); ``(result, row)``."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    kept, xr = res.kept.cpu().numpy(), res.xr.cpu().numpy()
    dev = float(res.deviation)
    if guarantee:
        re = check_guarantee(what, x, xr, kept, dev, cfg)
    else:
        re = remeasure(x, xr, cfg)
        require(abs(re - dev) <= 1e-9,
                f"{what}: re-measured deviation {re} != reported {dev}")
        require(np.array_equal(xr[kept], x[kept]),
                f"{what}: kept values are not bit-exact")
    iters = int(res.iters)
    return res, dict(
        dataset=name, n=x.shape[0], iters=iters,
        cr=x.shape[0] / float(kept.sum()), deviation=dev, remeasured=re,
        wall_s=wall, s_per_iter=wall / max(iters, 1), launches=counts,
        launches_per_iter=sum(counts.values()) / max(iters, 1),
        max_memory_allocated=torch.cuda.max_memory_allocated()
        if device.type == "cuda" else None)


def _lockstep_trace(snap: dict) -> dict:
    """The lockstep rounds' telemetry (``partitioned.*``) from a snapshot:
    rounds accepted and rejected, points removed, the last accepted round
    (from 0) and alpha's spread."""
    c, h = snap["counters"], snap["histograms"]["partitioned.alpha"]
    return dict(accepted=c.get("partitioned.rounds_accepted", 0),
                rejected=c.get("partitioned.rounds_rejected", 0),
                removed=c.get("partitioned.points_removed", 0),
                last_accepted_round=snap["gauges"].get(
                    "partitioned.last_accepted_round"),
                alpha={k: h[k] for k in ("min", "p50", "max", "sum")})


def phase_partitioned(device, name: str, T: int, length=None,
                      cpu_rounds: int = PART_CPU_ROUNDS) -> dict:
    """``compress_partitioned`` of ``name`` in T partitions on ``device``:
    the guarantee of the run, every kernel of its path launched
    (acf_window_impact a launch for each impact chunk, whatever T), the
    full-length run held against the same run through the plain versions
    on the card (the same iterations, CR within 5%; whether every field is
    equal is printed), and the first ``cpu_rounds`` rounds on the card
    equal to the same rounds on the CPU in every field, bit for bit.  The
    row carries the rounds' telemetry (accepted, rejected, alpha)."""
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=0, length=length)
    step = T * cfg.kappa
    x = x[:(x.shape[0] // step) * step]
    what = f"{name} partitioned T={T}"
    was = obs.OBS.enabled
    obs.reset()
    obs.OBS.enabled = True
    try:
        res, row = _part_row(device, what, name, x, cfg,
                             lambda: _par.compress_partitioned(
                                 x, cfg, T, device=device))
        row["trace"] = _lockstep_trace(obs.snapshot())
    finally:
        obs.OBS.enabled = was
    chunks = -(-(x.shape[0] // T) // cfg.impact_chunk)
    if device.type == "cuda":
        for kname in ("lag_dot", "prefix_sum", "acf_window_impact",
                      "segment_cells"):
            require(row["launches"][kname] > 0,
                    f"{what}: kernel {kname} was never launched")
        require(row["launches"]["acf_window_impact"]
                == chunks * row["iters"],
                f"{what}: {row['launches']['acf_window_impact']} "
                f"acf_window_impact launches in {row['iters']} rounds, not "
                f"{chunks} a round")
    row.update(path="partitioned", T=T, lags=cfg.lags, kappa=cfg.kappa,
               awi_launches_per_round=chunks,
               stopped_at_max_rounds=row["iters"] == cfg.max_rounds)
    if device.type == "cuda":
        plain_cfg = dataclasses.replace(cfg, backend="reference")
        plain, prow = _part_row(device, f"{what} plain", name, x, plain_cfg,
                                lambda: _par.compress_partitioned(
                                    x, plain_cfg, T, device=device))
        require(sum(prow["launches"].values()) == 0,
                f"{what} plain: a kernel was launched {prow['launches']}")
        require(prow["iters"] == row["iters"],
                f"{what}: {row['iters']} rounds, the plain versions' run "
                f"{prow['iters']}")
        require(abs(row["cr"] - prow["cr"]) <= 0.05 * prow["cr"],
                f"{what}: CR {row['cr']} is not within 5% of the plain "
                f"versions' {prow['cr']}")
        row.update(plain_cr=prow["cr"], plain_iters=prow["iters"],
                   plain_wall_s=prow["wall_s"],
                   same_as_plain=_same_result(res, plain),
                   same_kept_as_plain=bool(torch.equal(res.kept,
                                                       plain.kept)))
    if cpu_rounds and device.type == "cuda":
        short = dataclasses.replace(cfg, max_rounds=cpu_rounds)
        card = _par.compress_partitioned(x, short, T, device=device)
        t0 = time.perf_counter()
        cpu = _par.compress_partitioned(x, short, T, device="cpu")
        row.update(cpu_rounds=int(cpu.iters),
                   cpu_wall_s=time.perf_counter() - t0)
        require(_same_result(card, cpu),
                f"{what}: the first {cpu_rounds} rounds on the card differ "
                f"from the CPU's")
    return row


def phase_partitioned_dist(device, tmp: Path, name: str = "uk_elec",
                           B: int = PART_BATCH, length=None) -> dict:
    """On one rank of NCCL (gloo on the CPU) at world size 1: the shard
    form of ``name`` (one partition) held to the global form of one
    partition, and ``compress_batch(mesh=)`` of B series held to the
    unsharded batch, bit for bit."""
    import torch.distributed as dist
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=0, length=length)
    x = x[:(x.shape[0] // cfg.kappa) * cfg.kappa]
    rows = {}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{tmp / 'rdv'}",
                            world_size=1, rank=0)
    try:
        mesh = _shd.mesh_1d(device.type)
        res, rows["shard"] = _part_row(
            device, f"{name} shard form", name, x, cfg,
            lambda: _par.compress_partitioned_shardmap(x, cfg, mesh))
        want = _par.compress_partitioned(x, cfg, 1, device=device)
        require(_same_result(res, want),
                f"{name} shard form: not the global form's bits")
        xs = batch_series(name, B, length)
        reset_counts()
        t0 = time.perf_counter()
        got = cameo.compress_batch(xs, cfg, mesh=mesh)
        wall = time.perf_counter() - t0
        rows["mesh_batch"] = dict(B=B, rounds=int(torch.max(got.iters)),
                                  wall_s=wall, launches=read_counts())
        require(_same_result(got, cameo.compress_batch(xs, cfg,
                                                       device=device)),
                f"{name} compress_batch(mesh=): not the unsharded bits")
    finally:
        dist.destroy_process_group()
    return rows


def run_partitioned(device, sizes=None, cpu_rounds: int = PART_CPU_ROUNDS,
                    partitions=PARTITIONED, log=print) -> dict:
    """The partitioned phase: the global runs of ``partitions`` (dataset,
    T), the local form of the first, then the shard form and
    ``compress_batch(mesh=)`` (in a temporary directory under ``build/``
    for the rendezvous).  ``sizes`` maps a dataset to a shorter length
    (the CPU rehearsal)."""
    import tempfile
    device = torch.device(device)
    sizes = sizes or {}
    t0 = time.perf_counter()
    rows, launches = [], dict.fromkeys(WRAPPERS, 0)

    def add(row):
        rows.append(row)
        for kname, c in row["launches"].items():
            launches[kname] += c
        log("partitioned " + json.dumps(row))

    for name, T in partitions:
        add(phase_partitioned(device, name, T, sizes.get(name), cpu_rounds))
    name, T = partitions[0]
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=0, length=sizes.get(name))
    _, row = _part_row(device, f"{name} local T={T}", name, x, cfg,
                       lambda: _par.compress_partitioned_local(
                           x, cfg, T, device=device), guarantee=False)
    row.update(path="partitioned_local", T=T)
    add(row)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dist_rows = phase_partitioned_dist(device, Path(tmp), name,
                                           length=sizes.get(name))
    for key, row in dist_rows.items():
        row.update(path=key)
        if key == "shard":
            row["T"] = 1
        add(row)
    return dict(rows=rows, launches=launches,
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the baselines phase (baselines/: the paper's comparison methods)
# ---------------------------------------------------------------------------

# the parameterized methods' searches (the benchmark's own setting: 8
# bisection steps), each with whether its parameter is an integer (FFT's
# kept-coefficient count)
BASELINE_SEARCH = (("pmc", False), ("swing", False), ("simpiece", False),
                   ("fft", True))
BASELINE_ITERS = 8
# the CPU path's runs of uk_elec the card's are held to: worker processes
# started after phase 4 (the main paths' CPU pool is done by then), one
# torch thread each (~25 s a line-simplification rank on one core)
BASELINE_CPU_WORKERS = 2
BASELINE_CPU_THREADS = 1
# the segment_scan holds: the dataset's parameter from the search, and
# this many times it
SEGMENT_SCAN_SPREAD = 10.0


def _search_fn(method: str):
    return {"pmc": _bl.pmc_compress, "swing": _bl.swing_compress,
            "simpiece": _bl.simpiece_compress,
            "fft": _bl.fft_compress}[method]


def _baseline_series(name: str, length=None):
    cfg = cameo.CameoConfig(eps=EPS, **dataset_cameo_kwargs(name))
    x = make_dataset(name, seed=0, length=length)
    return x[:(x.shape[0] // cfg.kappa) * cfg.kappa], cfg


def baseline_cpu_rank(name: str, rank: str, length=None) -> dict:
    """The CPU path's ``compress_baseline`` of ``name`` by ``rank``: kept
    mask, rounds, deviation and the per-round trace."""
    x, cfg = _baseline_series(name, length)
    trace = []
    t0 = time.perf_counter()
    res = _bl.line_simpl.compress_baseline(x, cfg, rank, device="cpu",
                                           trace=trace)
    return dict(kept=res.kept.numpy(), iters=int(res.iters),
                deviation=float(res.deviation), trace=trace,
                wall_s=time.perf_counter() - t0)


def baseline_cpu_searches(name: str, length=None) -> dict:
    """The CPU path's searches of ``name``: each method's parameter,
    storage and deviation."""
    x, cfg = _baseline_series(name, length)
    out = {}
    for method, isint in BASELINE_SEARCH:
        _, stored, dev, p = _bl.acf_constrained_search(
            x, cfg, _search_fn(method), param_is_int=isint,
            iters=BASELINE_ITERS, device="cpu")
        out[method] = dict(param=p, stored=stored, deviation=dev)
    return out


def baseline_references(name: str, length=None) -> tuple:
    """Start the CPU path's runs of ``name`` (every rank, the searches) in
    ``BASELINE_CPU_WORKERS`` spawned processes; ``(pool, {key: future})``.
    The caller shuts the pool down."""
    pool = concurrent.futures.ProcessPoolExecutor(
        BASELINE_CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init, initargs=(BASELINE_CPU_THREADS,))
    futs = {("search",): pool.submit(baseline_cpu_searches, name, length)}
    for rank in _bl.LINE_SIMPL_BASELINES:
        futs[("rank", rank)] = pool.submit(baseline_cpu_rank, name, rank,
                                           length)
    return pool, futs


def _first_differing_round(a: list, b: list):
    """The first round whose (accepted, picks, deviation bits) differ
    between two traces, with both; None where none does."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        if ra != rb:
            return dict(round=i, card=list(ra), cpu=list(rb))
    return None if len(a) == len(b) else dict(round=min(len(a), len(b)))


def segment_scan_entry(device, name: str, x: np.ndarray, mode: str,
                       errs) -> dict:
    """segment_scan of ``mode`` at ``name``'s full length against its plain
    version at tolerance 0 (every output, bit for bit), at each of
    ``errs``, and the series in float32 at the first (PMC keeps a float32
    series' type); timed at the first in float64 with CUDA events beside
    its plain version (one call, a walk on the host); the bound counts the
    bytes it must move and its float64 operations."""
    xt = torch.from_numpy(x).to(device)
    n = x.shape[0]
    err_max, plain_ms = 0.0, None
    for xs, err in [(xt, e) for e in errs] + [(xt.float(), errs[0])]:
        got = _segscan.segment_scan_cuda(xs, err, mode)
        want, ms = timed_once(
            lambda: _segscan.segment_scan_plain(xs, err, mode), device)
        plain_ms = ms if plain_ms is None else plain_ms
        for g, w in zip(got, want):
            require(torch.equal(g, w),
                    f"{name} segment_scan {mode} {xs.dtype} err={err}: the "
                    f"kernel disagrees with its plain version in "
                    f"{int((g != w).sum())} of {n} outputs")
            if g.dtype.is_floating_point:
                err_max = max(err_max, float((g - w).abs().max()))
    # PMC: read n values, write n flags; a min, a max, a subtraction and a
    # compare a point.  Swing: read n values, write n flags and 4 n values;
    # ~14 operations a point (two divisions)
    nbytes = 8 * n + n + (32 * n if mode == "swing" else 0)
    flops = (4 if mode == "pmc" else 14) * n
    bnd, by = bound_ms(nbytes, flops, FP64_FLOPS)
    ms = device_ms(lambda: _segscan.segment_scan_cuda(xt, errs[0], mode),
                   device, reps=3, inner=3)
    return dict(name="segment_scan", dataset=name,
                shape=f"{mode} n={n} float64, err {errs[0]:.6g} and "
                      f"{errs[1]:.6g}; float32 at the first",
                max_abs_err=err_max, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bnd, bound_by=by)


def phase_baselines(device, name: str, length=None, refs=None,
                    log=print) -> dict:
    """The baselines of ``name`` on ``device`` at eps = 1e-2: the five
    line-simplification ranks through ``compress_baseline`` with their
    guarantee, the four parameterized methods through
    ``acf_constrained_search`` (8 steps) with a re-measure of the
    deviation, and the lossless counters equal to their loop forms.  With
    ``refs`` (the CPU path's runs, :func:`baseline_references`), each rank's
    kept mask, rounds, deviation bits and every round's (accepted, picks,
    deviation bits) are held to the CPU's (a failure names the first round
    that parts), and each search's parameter and storage to the CPU's."""
    x, cfg = _baseline_series(name, length)
    n = x.shape[0]
    ranks, searches = [], []
    for rank in _bl.LINE_SIMPL_BASELINES:
        trace = []
        res, wall, mem = _run_timed(
            lambda: _bl.line_simpl.compress_baseline(
                x, cfg, rank, device=device, trace=trace), device)
        kept = res.kept.cpu().numpy()
        dev = float(res.deviation)
        re = check_guarantee(f"{name} {rank}", x, res.xr.cpu().numpy(), kept,
                             dev, cfg)
        row = dict(dataset=name, method=rank, n=n, rounds=int(res.iters),
                   accepted=sum(t[0] for t in trace), cr=n / float(kept.sum()),
                   deviation=dev, remeasured=re, wall_s=wall,
                   s_per_round=wall / max(int(res.iters), 1),
                   max_memory_allocated=mem)
        if refs:
            ref = refs[("rank", rank)].result()
            require(np.array_equal(kept, ref["kept"]),
                    f"{name} {rank}: the card's kept mask differs from the "
                    f"CPU path's")
            require(int(res.iters) == ref["iters"],
                    f"{name} {rank}: {int(res.iters)} rounds on the card, "
                    f"{ref['iters']} on the CPU")
            first = _first_differing_round(trace, ref["trace"])
            require(first is None and dev.hex() == ref["deviation"].hex(),
                    f"{name} {rank}: the card's rounds part from the CPU "
                    f"path's (deviation {dev.hex()} against "
                    f"{ref['deviation'].hex()}), first at {first}")
            row.update(same_kept=True, rounds_cpu=ref["iters"],
                       wall_s_cpu=ref["wall_s"], deviation_bits_equal=True)
        ranks.append(row)
        log("baseline " + json.dumps(row))
    ref_search = refs[("search",)].result() if refs else {}
    for method, isint in BASELINE_SEARCH:
        fn, host_s = _search_fn(method), [0.0]

        def timed_fn(xd, p, device):
            # the method's own seconds (Sim-Piece's: its host loop)
            t = time.perf_counter()
            out = fn(xd, p, device=device)
            host_s[0] += time.perf_counter() - t
            return out
        (recon, stored, dev, p), wall, _ = _run_timed(
            lambda: _bl.acf_constrained_search(
                x, cfg, timed_fn, param_is_int=isint,
                iters=BASELINE_ITERS, device=device), device)
        require(recon.device.type == device.type and recon.shape == (n,),
                f"{name} {method}: reconstruction {tuple(recon.shape)} on "
                f"{recon.device}")
        re = remeasure(x, recon.cpu().numpy(), cfg)
        require(re <= cfg.eps + 1e-12 and abs(re - dev) <= 1e-9,
                f"{name} {method}: deviation {dev}, re-measured {re}, "
                f"eps {cfg.eps}")
        row = dict(dataset=name, method=method, n=n, param=p, stored=stored,
                   cr=n / stored, deviation=dev, remeasured=re, wall_s=wall,
                   method_s=host_s[0])
        if method in ref_search:
            ref = ref_search[method]
            require(p == ref["param"] and stored == ref["stored"],
                    f"{name} {method}: parameter {p} and storage {stored} on "
                    f"the card, {ref['param']} and {ref['stored']} on the "
                    f"CPU")
            require(dev.hex() == ref["deviation"].hex() or method == "fft",
                    f"{name} {method}: deviation {dev!r} on the card, "
                    f"{ref['deviation']!r} on the CPU")
            # FFT's coefficients come from cuFFT on the card, PocketFFT on
            # the CPU: its deviation is compared, not held
            row.update(param_cpu=ref["param"], stored_cpu=ref["stored"],
                       deviation_bits_equal=dev.hex() ==
                       ref["deviation"].hex())
        searches.append(row)
        log("baseline " + json.dumps(row))
    lossless = {}
    for codec, fast, loop in (
            ("gorilla", _bl.gorilla_bits_per_value,
             _bl.lossless.gorilla_bits_per_value_loop),
            ("chimp", _bl.chimp_bits_per_value,
             _bl.lossless.chimp_bits_per_value_loop)):
        bits = fast(x)
        require(bits == loop(x), f"{name} {codec}: the counter and its loop "
                                 f"form disagree")
        lossless[codec] = bits
    log("baseline " + json.dumps(dict(dataset=name, bits_per_value=lossless)))
    return dict(x=x, ranks=ranks, searches=searches, lossless=lossless)


def run_baselines(device, sizes=None, refs=None, log=print) -> dict:
    """The baselines phase: :func:`phase_baselines` of both datasets (uk_elec
    held to the CPU path's ``refs``), the counts read around it; then
    segment_scan held to its plain version on each dataset in both modes
    at the error bound its search settled on and ``SEGMENT_SCAN_SPREAD``
    times it (launches made to compare do not count)."""
    device = torch.device(device)
    sizes = sizes or {}
    t0 = time.perf_counter()
    reset_counts()
    out = {name: phase_baselines(device, name, sizes.get(name),
                                 refs if name == DATASETS[0] else None, log)
           for name in DATASETS}
    launches = read_counts()
    if device.type == "cuda":
        for kname in ("lag_dot", "prefix_sum", "dense_sxx", "segment_scan"):
            require(launches[kname] > 0,
                    f"baselines: kernel {kname} was never launched")
    seconds = time.perf_counter() - t0
    kernels = []
    for name, ph in out.items():
        params = {r["method"]: r["param"] for r in ph["searches"]}
        for mode in _segscan.MODES:
            kernels.append(segment_scan_entry(
                device, name, ph["x"], mode,
                (params[mode], SEGMENT_SCAN_SPREAD * params[mode])))
    rows = [r for ph in out.values() for r in ph["ranks"] + ph["searches"]]
    simpiece_s = {name: next(r["method_s"] for r in ph["searches"]
                             if r["method"] == "simpiece")
                  for name, ph in out.items()}
    return dict(rows=rows, kernels=kernels, launches=launches,
                lossless={name: ph["lossless"] for name, ph in out.items()},
                simpiece_host_s=simpiece_s, seconds=seconds,
                seconds_with_holds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the serving phase (the model zoo's attention path, ``serving/``)
# ---------------------------------------------------------------------------

# qwen3-0.6b at its published width in its own bfloat16, weights from seed
# 0: generation (B prompts of S tokens, S > attn_chunk: the chunked
# prefill), the float32 cache path (``cache_B`` rows, ``forward`` over S,
# ``prefill`` over ``cache_prefill`` (unchunked) and ``cache_steps``
# teacher-forced decode steps), CAMEO's KV selection of the generation's
# prefill caches (``keep`` of S + new positions at ``lags``; the held
# layers' lanes equal the CPU path's), ``pruned_steps`` decode steps on the
# compacted cache, and the reduced config card against CPU
SERVE = dict(arch="qwen3-0.6b", reduced=False, attn_chunk=None, B=8, S=2048,
             new=32, cache_B=2, cache_prefill=1024, cache_steps=32, keep=512,
             lags=16, held_layers=(0, -1), pruned_steps=8, small_B=4,
             small_S=64, small_new=16)
# decode logits against forward's at the same position (float32, TF32
# off), and the reduced config's logits card against CPU: |diff| <= tol x
# RMS(logits); a greedy token may part only where the CPU's top-2 margin is
# within 10 tol x RMS
SERVE_CACHE_TOL = 1e-3
SERVE_SMALL_TOL = 1e-4
# the bfloat16 generation's prefill (last position) and first decode step
# against the float32 forward on the same tokens: |diff| <= tol x RMS.
# bfloat16 rounds every projection to 8 bits, and over 28 layers the
# reference itself drifts from its float32 run by ~5% of the RMS
# (tests/test_torch_models.py::test_bfloat16_drift_from_float32_is_the_
# reference_s, which holds the port's drift to the reference's): tol is
# twice that.  The greedy tokens equal the float32 argmax wherever its
# top-2 margin exceeds twice the measured error (no near-tie).
SERVE_BF16_TOL = 1e-1
# the kernels CAMEO's selection launches (compress_batch's rounds path)
SERVE_KERNELS = ("lag_dot", "prefix_sum", "dense_sxx", "acf_impact",
                 "window_rows", "segment_cells")
# the KV selection's first segment_cells launches rank only slots in the
# bucket's zero padding: its hold takes the first launch with cells that
# are not all zero (the predicate syncs the card until one is recorded)
SERVE_KEEP = {"segment_cells": lambda out: bool(torch.any(out[0] != 0))}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serving_cpu_select(keys: np.ndarray, pos_ids: np.ndarray, keep: int,
                       lags: int) -> dict:
    """The CPU path's importance series and ``select_positions`` of the held
    layers' lanes (``keys [lanes, S, K, dh]`` float32, exact copies of the
    cache's values)."""
    k = torch.from_numpy(keys)
    one = torch.ones(1)
    cache = KVCache(k=k, v=k, pos_ids=torch.from_numpy(pos_ids), k_scale=one,
                    v_scale=one)
    t0 = time.perf_counter()
    sig = kv_prune.importance_series(cache)
    idx = kv_prune.select_positions(cache, keep, lags)
    return dict(sig=sig.numpy(), idx=idx.numpy(),
                seconds=time.perf_counter() - t0)


def _serve_generate(device, cfg, params, sz, init_s, log) -> tuple:
    """Item 1: a warm and a timed greedy ``Engine.generate``; the tokens of
    both calls equal and in range.  Returns (row, prompts, tokens)."""
    B, S, new = sz["B"], sz["S"], sz["new"]
    attends = any(ls.kind == "attn" for ls in cfg.all_layers())
    require(not attends or (cfg.attn_chunk is not None
                            and S > cfg.attn_chunk),
            f"serve: S = {S} does not take the chunked prefill "
            f"(attn_chunk {cfg.attn_chunk})")
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=new), device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    first = eng.generate(prompts)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    toks = eng.generate(prompts)
    _sync(device)
    wall = time.perf_counter() - t0
    require(np.array_equal(first, toks),
            "serve: two greedy generate calls gave other tokens")
    require(toks.shape == (B, new) and toks.min() >= 0
            and toks.max() < cfg.vocab, "serve: token ids out of range")
    st = eng.stats
    row = dict(
        step="generate", arch=cfg.name, dtype=cfg.param_dtype, B=B, S=S,
        new_tokens=new, chunked_prefill=attends, deterministic=True,
        prefill_s=st["prefill_s"],
        decode_ms_per_token=1e3 * st["decode_s"] / max(st["decode_steps"], 1),
        tokens_per_s=B * new / wall, wall_s=wall, init_s=init_s,
        max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None))
    log("serve " + json.dumps(row))
    return row, prompts, toks


def _recorder(wrapper, calls: list, limit, keep):
    def recording(*a, **kw):
        out = wrapper(*a, **kw)
        # a wrapper that its own module calls by this attribute counted on
        # the recorder: the count goes to the wrapper
        wrapper.launches += recording.launches
        recording.launches = 0
        if (limit is None or len(calls) < limit) and (keep is None
                                                      or keep(out)):
            calls.append((tuple(_clone(t) for t in a),
                          {k: _clone(v) for k, v in kw.items()},
                          _clone(out)))
        return out
    recording.launches = 0
    return recording


@contextlib.contextmanager
def record_launches(names, limit=None, keep=None):
    """Within the block, the wrappers of the kernels ``names`` record their
    launches (at most ``limit`` of each, and of a kernel named in ``keep``
    only those whose output its predicate takes) as (arguments, keywords,
    output), cloned, into the yielded dict's lists; they launch and count as
    ever."""
    got, saved, keep = {k: [] for k in names}, [], keep or {}
    for kname in names:
        rec = _recorder(WRAPPERS[kname], got[kname], limit, keep.get(kname))
        for mod, attr in CALLERS[kname]:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, rec)
    try:
        yield got
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _clone(v):
    if isinstance(v, tuple):
        return tuple(_clone(t) for t in v)
    return v.clone() if isinstance(v, torch.Tensor) else v


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.all(
        (a == b) | (torch.isnan(a) & torch.isnan(b))
        if a.is_floating_point() else a == b))


def _finite_err(a: torch.Tensor, b: torch.Tensor) -> float:
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.max(torch.abs(a - b)[ok])) if bool(ok.any()) else 0.0


def serving_kernel_entries(device, rec: dict) -> list:
    """Each kernel's first launch in the KV selection (``rec``, from
    :func:`record_launches`; segment_cells' first with cells that are not
    all zero, ``SERVE_KEEP``), on its recorded inputs (the main path's
    shapes): a second launch gives the recorded bits, and those equal its
    plain version's (tolerance 0); timed beside its plain version and,
    where one exists, a PyTorch call.  Launches here are not counted by
    the caller."""
    out = []
    for kname, (a, kw, res) in ((k, c[0]) for k, c in rec.items() if c):
        if kname in ("prefix_sum", "dense_sxx"):
            # their own entries: held to the plain version on the CPU, lanes
            # to their one-lane launches, timed with the library's call
            e = (prefix_sum_entry(device, "serving", a[0], a[0].shape[0])
                 if kname == "prefix_sum" else
                 dense_sxx_entry(device, "serving", *a, lanes=a[0].shape[0]))
            require(_same_bits(WRAPPERS[kname](*a, **kw), res),
                    f"serving {kname}: a second launch gave other bits")
            out.append(dict(e, dataset="serving"))
            continue
        if kname == "segment_cells":
            # every output held, the x-space window too, on cells that are
            # not all zero; timed beside the pair it replaces
            xr, prev, nxt, cand, W, kap = a[:6]
            what = "serving segment_cells"
            err = segment_cells_hold(what, a[:6])
            require(all(_same_bits(g, r) for g, r in zip(
                WRAPPERS[kname](*a, **kw), res)),
                f"{what}: a second launch gave other bits")
            shape = (f"B={xr.shape[0]} lanes x K={cand.shape[-1]} W={W} "
                     f"kappa={kap} n={xr.shape[-1]} {str(xr.dtype)[6:]}")
            cfg = cameo.CameoConfig(kappa=kap)
            e = _lanes_entry(
                kname, shape, err,
                device_ms(lambda: WRAPPERS[kname](*a[:6]), device),
                device_ms(lambda: _segcells.segment_cells_plain(*a[:6]),
                          device, reps=3, inner=3),
                segment_cells_bound(xr.cpu(), prev.cpu(), nxt.cpu(),
                                    cand.cpu(), W, kap), xr.shape[0])
            e.update(pair_ms=device_ms(lambda: _ops.x_window_to_y(
                cfg, *segment_deltas(xr, prev, nxt, cand, W)[:2]), device,
                reps=3, inner=3))
            out.append(dict(e, dataset="serving"))
            continue
        fn = WRAPPERS[kname]
        plain = {"lag_dot": _lag_dot.lag_dot_plain,
                 "acf_impact": _acf_impact.acf_impact_plain,
                 "window_rows": _fused.window_rows_plain}[kname]
        got = fn(*a, **kw)
        # lag_dot's plain version chains every add of a lag on the card
        # (seconds at 224 lanes): one timed call, the others' repeated
        want, plain_ms = timed_once(lambda: plain(*a, **kw), device)
        if kname != "lag_dot":
            plain_ms = device_ms(lambda: plain(*a, **kw), device, reps=3,
                                 inner=3)
        require(_same_bits(got, res),
                f"serving {kname}: a second launch gave other bits")
        require(_same_bits(got, want),
                f"serving {kname}: the kernel differs from its plain version "
                f"on the main path's inputs")
        y, L, B = a[0], kw["L"], a[0].shape[0]
        dt, library = str(y.dtype)[6:], None
        if kname == "lag_dot":
            n = y.shape[-1]
            shape = f"B={B} lanes x n={n} L={L} {dt}"
            bound = lag_dot_bound(B, n, L, y.dtype)
            if all(t is None for t in a[1:]) and not {"b", "halo"} & set(kw):
                ext = F.pad(y, (0, L))
                library = device_ms(lambda: F.conv1d(
                    ext[None, :, 1:], y[:, None, :], groups=B), device)
        elif kname == "acf_impact":
            nyb, P = y.shape[-1], a[1].shape[-1]
            shape = (f"B={B} lanes x P={P} nyb={nyb} kappa="
                     f"{kw.get('kappa', 1)} L={L} {dt}")
            bound = acf_impact_bound(B, P, nyb, L, y.dtype)
        else:
            K, Wy = a[1].shape[-2:]
            shape = f"B={B} lanes x K={K} Wy={Wy} L={L} {dt}"
            bound = window_rows_bound(B * K, Wy, L, B * y.shape[-1])
        out.append(dict(_lanes_entry(
            kname, shape, _finite_err(got, want),
            device_ms(lambda: fn(*a, **kw), device), plain_ms, bound, B,
            library), dataset="serving"))
    return out


def _serve_prune(device, cfg, params, prompts, toks, sz, pool, log) -> dict:
    """Item 3: ``prune_tree`` of the generation's prefill caches through
    ``compress_batch`` on ``device`` (counted); the held layers' series and
    kept indices equal the CPU path's, the kept entries are bit-exact
    copies; then decode steps on the compacted cache."""
    B, S, new, keep, lags = (sz[k] for k in ("B", "S", "new", "keep",
                                              "lags"))
    with torch.inference_mode():
        logits, caches = prefill(
            params, cfg, {"tokens": torch.from_numpy(prompts).long().to(
                device)}, max_len=S + new)
    cache = caches["blocks"]["sub0"]
    nl, _, size, K, dh = cache.k.shape
    held = sorted({l % nl for l in sz["held_layers"]})
    # the held layers' lanes, in prune_tree's fold order (layer-major)
    hk = cache.k[held].reshape(len(held) * B, size, K, dh)
    hp = cache.pos_ids[held].reshape(len(held) * B, size)
    args = (hk.float().cpu().numpy(), hp.cpu().numpy(), keep, lags)
    fut = pool.submit(serving_cpu_select, *args) if pool is not None \
        else None
    was = obs.OBS.enabled
    obs.reset()
    obs.OBS.enabled = True
    try:
        reset_counts()
        with record_launches(SERVE_KERNELS, limit=1, keep=SERVE_KEEP) as rec:
            _sync(device)
            t0 = time.perf_counter()
            pruned = kv_prune.prune_tree(caches, keep, lags)
            _sync(device)
            sel_s = time.perf_counter() - t0
        launches = read_counts()
        rounds = obs.OBS.counter_value("cameo.batch_rounds_total")
    finally:
        obs.OBS.enabled = was
    if device.type == "cuda":
        for kname in SERVE_KERNELS:
            require(launches[kname] > 0,
                    f"serve: kernel {kname} was never launched by the KV "
                    f"selection")
    kernels = serving_kernel_entries(device, rec)
    require(sorted(k["name"] for k in kernels) == sorted(
        SERVE_KERNELS if device.type == "cuda" else ()),
        f"serve: held {[k['name'] for k in kernels]} of the selection's "
        f"kernels")
    for k in kernels:
        log(f"kernel {k['name']} serving [{k['shape']}] max_abs_err="
            f"{k['max_abs_err']:.3e} tol 0 ms={k['ms']} plain_ms="
            f"{k['plain_ms']} library_ms={k['library_ms']} bound_ms="
            f"{k['bound_ms']:.3e} ({k['bound_by']})")
    pc = pruned["blocks"]["sub0"]
    require(tuple(pc.k.shape) == (nl, B, keep, K, dh),
            f"serve: pruned cache shape {tuple(pc.k.shape)}")
    one = torch.ones(1, device=device)
    held_cache = KVCache(k=hk, v=hk, pos_ids=hp, k_scale=one, v_scale=one)
    card_sig = kv_prune.importance_series(held_cache).cpu().numpy()
    card_idx = kv_prune.select_positions(held_cache, keep, lags).cpu().numpy()
    cpu = fut.result() if fut is not None else serving_cpu_select(*args)
    require(np.array_equal(card_sig.view(np.int32), cpu["sig"].view(np.int32)),
            f"serve: the card's importance series differs from the CPU's in "
            f"{int(np.sum(card_sig != cpu['sig']))} of {card_sig.size} values")
    require(np.array_equal(card_idx, cpu["idx"]),
            f"serve: the card's kept indices differ from the CPU path's in "
            f"{int(np.sum(np.any(card_idx != cpu['idx'], axis=1)))} lanes")
    # prune_tree's kept entries are bit-exact copies at the CPU's indices
    bidx = torch.arange(len(held) * B, device=device)[:, None]
    ci = torch.from_numpy(cpu["idx"]).long().to(device)
    for field, src in (("k", hk), ("v", cache.v[held].reshape(hk.shape)),
                       ("pos_ids", hp)):
        got = getattr(pc, field)[held].reshape((len(held) * B, keep)
                                               + src.shape[2:])
        require(torch.equal(got, src[bidx, ci]),
                f"serve: pruned {field} is not the held lanes' entries at "
                f"the CPU path's indices")
    # the logits the float32 forward holds (item 2): the prefill's last
    # position and a first decode step on the unpruned cache, of the first
    # cache_B rows
    nb = sz["cache_B"]
    with torch.inference_mode():
        step0, _ = decode_step(params, cfg, torch.from_numpy(
            toks[:, :1]).long().to(device), caches, S)
    bf16 = dict(tokens=np.concatenate([prompts[:nb], toks[:nb, :1]], 1),
                greedy=toks[:nb, :2],
                logits=torch.cat([logits[:nb, -1:], step0[:nb]], 1).float())
    del caches, cache, hk, hp, held_cache, step0
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    agree = []
    for i in range(sz["pruned_steps"]):
        agree.append(float(np.mean(tok.cpu().numpy() == toks[:, i])))
        with torch.inference_mode():
            logits, pruned = decode_step(params, cfg, tok[:, None], pruned,
                                         S + i)
        require(bool(torch.isfinite(logits).all()),
                f"serve: decode step {i} on the pruned cache gave non-finite "
                f"logits")
        tok = torch.argmax(logits[:, -1, :], dim=-1)
    cfg_sel = kv_prune.selection_config(size, keep, lags)
    row = dict(
        step="kv_prune", layers=nl, lanes=nl * B, positions=size, keep=keep,
        lags=cfg_sel.lags, round_bucket=cameo._round_bucket(size, cfg_sel),
        dtype=cfg_sel.dtype, target_cr=cfg_sel.target_cr, seconds=sel_s,
        rounds_total=rounds, rounds_per_lane=rounds / (nl * B),
        launches=launches, held_layers=held, held_lanes=len(held) * B,
        series_bits_equal_cpu=True, kept_equal_cpu=True,
        kept_entries_bit_exact=True, cpu_select_s=cpu["seconds"],
        pruned_decode_steps=sz["pruned_steps"],
        pruned_tokens_agree_unpruned=agree)
    log("serve " + json.dumps(row))
    return row, kernels, bf16


def _hold_bf16(bf16: dict, ref: torch.Tensor, log) -> dict:
    """The bfloat16 prefill's last-position logits and first decode step
    (``bf16``) against the float32 forward's at the same positions
    (``ref [B, 2, V]``), and the greedy tokens outside near-ties."""
    got = bf16["logits"]
    rms = float(torch.sqrt(torch.mean(ref.double() ** 2)))
    err = float(torch.max(torch.abs(got - ref)))
    top2 = torch.topk(ref, 2, dim=-1).values
    sure = ((top2[..., 0] - top2[..., 1]) > 2 * err).cpu()
    want = torch.argmax(ref, dim=-1).cpu().numpy()
    parted = int(np.sum((want != bf16["greedy"]) & sure.numpy()))
    row = dict(step="bf16_vs_float32", B=got.shape[0],
               positions=["prefill last", "decode 0"], max_abs_err=err,
               logits_rms=rms, err_over_rms=err / rms, tol=SERVE_BF16_TOL,
               tokens_sure=int(sure.sum()), tokens_parted_sure=parted)
    log("serve " + json.dumps(row))
    require(err <= SERVE_BF16_TOL * rms,
            f"serve: the bfloat16 logits part from the float32 forward's by "
            f"{err} > {SERVE_BF16_TOL} x RMS {rms}")
    require(parted == 0,
            f"serve: {parted} bfloat16 greedy tokens differ from the float32 "
            f"forward's outside a near-tie")
    return row


def _serve_cache_path(device, cfg, params, sz, bf16, log) -> tuple:
    """Item 2: in float32, decode steps after an unchunked prefill equal
    ``forward``'s chunked logits at the same positions; the bfloat16 run's
    logits (``bf16``) are held to a float32 ``forward`` (unchunked) over
    the same tokens."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activ_dtype="float32")
    params.float()
    B, S, P, steps = (sz[k] for k in ("cache_B", "S", "cache_prefill",
                                      "cache_steps"))
    require(S > cfg.attn_chunk >= P,
            f"serve: forward over {S} must be chunked and prefill over {P} "
            f"not (attn_chunk {cfg.attn_chunk})")
    with torch.inference_mode():
        ref, _ = forward(params, dataclasses.replace(cfg32, attn_chunk=None),
                         {"tokens": torch.from_numpy(bf16["tokens"]).long()
                          .to(device)})
        ref = ref[:, S - 1:S + 1].clone()
    held = _hold_bf16(bf16, ref, log)
    del ref
    return _decode_vs_forward(device, cfg32, params, B, S, P, steps,
                              log), held


def _decode_vs_forward(device, cfg32, params, B: int, S: int, P: int,
                       steps: int, log) -> dict:
    """In float32: ``steps`` teacher-forced decode steps after a ``P``-token
    prefill equal ``forward``'s logits over ``S`` tokens at the same
    positions within ``SERVE_CACHE_TOL`` x RMS."""
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg32.vocab, size=(B, S))).long().to(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        full, _ = forward(params, cfg32, {"tokens": toks})
        want = full[:, P:P + steps].clone()
        del full
        _, caches = prefill(params, cfg32, {"tokens": toks[:, :P]},
                            max_len=P + steps)
        got = []
        for i in range(steps):
            ld, caches = decode_step(params, cfg32, toks[:, P + i:P + i + 1],
                                     caches, P + i)
            got.append(ld[:, 0])
        got = torch.stack(got, dim=1)
    _sync(device)
    rms = float(torch.sqrt(torch.mean(want.double() ** 2)))
    err = float(torch.max(torch.abs(got - want)))
    require(bool(torch.isfinite(got).all()) and err <= SERVE_CACHE_TOL * rms,
            f"serve {cfg32.name}: decode logits part from forward's by {err} "
            f"> {SERVE_CACHE_TOL} x RMS {rms}")
    row = dict(step="cache_path", arch=cfg32.name, layers=cfg32.n_layers,
               dtype="float32", B=B, forward_S=S, prefill_S=P,
               decode_steps=steps, max_abs_err=err, logits_rms=rms,
               tol=SERVE_CACHE_TOL, seconds=time.perf_counter() - t0)
    log("serve " + json.dumps(row))
    return row


@contextlib.contextmanager
def record_routes():
    """Within the block, every MoE router call (``models.moe.route``)
    appends its probabilities and expert ids, on the host, to the yielded
    list."""
    got, orig = [], _moe.route

    def recording(p, x, k):
        out = orig(p, x, k)
        got.append((out[1].detach().float().cpu(), out[3].cpu()))
        return out
    _moe.route = recording
    try:
        yield got
    finally:
        _moe.route = orig


def _route_parts(card: list, cpu: list, k: int, S: int):
    """The tokens whose top-k expert sets differ between the card's routes
    and the CPU's (layer by layer, ``[B, S, E]`` probabilities and
    ``[B, S, k]`` ids), each required to be a near-tie on the CPU (its
    k-th and (k+1)-th probabilities within ``ROUTE_TIE``).  Returns (parts,
    near-tie tokens, each row's first parted position or S)."""
    parts = ties = 0
    first = None
    for (pd, ed), (pc, ec) in zip(card, cpu):
        top = torch.sort(pc, dim=-1, descending=True).values
        tie = (top[..., k - 1] - top[..., k]) <= ROUTE_TIE
        differ = torch.any(torch.sort(ed, -1).values
                           != torch.sort(ec, -1).values, dim=-1)
        require(not bool(torch.any(differ & ~tie)),
                f"serve small: {int(torch.sum(differ & ~tie))} tokens route "
                f"to other experts on the card outside a near-tie")
        parts += int(differ.sum())
        ties += int(tie.sum())
        pos = torch.where(differ, torch.arange(differ.shape[1]), S)
        f = pos.min(dim=1).values
        first = f if first is None else torch.minimum(first, f)
    return parts, ties, first


def _serve_small(device, arch: str, sz, log) -> dict:
    """Item 4: the reduced config (float32) from the same seed on the card
    and on the CPU: logits of the teacher-forced sequence within tol x RMS,
    greedy tokens equal but where the CPU's top-2 margin is a near-tie.  An
    MoE config's routes equal the CPU's but at near-ties (counted); a row's
    logits are held before its first parted route."""
    cfg = get_reduced(arch)
    B, S, new = sz["small_B"], sz["small_S"], sz["small_new"]
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=new)
    out = {}
    for where in ("cpu", device):
        params = init_params(model_defs(cfg), 0, where, cfg.pdtype())
        toks = Engine(cfg, params, scfg, device=where).generate(prompts)
        out[str(where)] = (params, toks)
    (pc, tc), (pd, td) = out["cpu"], out[str(device)]
    seq = torch.from_numpy(np.concatenate([prompts, tc], axis=1)).long()
    with torch.inference_mode():
        with record_routes() as rc:
            lc, _ = forward(pc, cfg, {"tokens": seq})
        with record_routes() as rd:
            ld, _ = forward(pd, cfg, {"tokens": seq.to(device)})
    ld = ld.cpu()
    parts, ties, first = _route_parts(rd, rc, cfg.top_k, seq.shape[1]) \
        if cfg.n_experts else (0, 0, None)
    rms = float(torch.sqrt(torch.mean(lc.double() ** 2)))
    diff = torch.abs(ld - lc)
    if first is not None:
        diff = diff * (torch.arange(seq.shape[1])[None, :, None]
                       < first[:, None, None])
    err = float(torch.max(diff))
    require(err <= SERVE_SMALL_TOL * rms,
            f"serve small: card logits part from the CPU's by {err} > "
            f"{SERVE_SMALL_TOL} x RMS {rms}")
    top2 = torch.topk(lc[:, S - 1:S - 1 + new], 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    near_ties = 0
    for b in range(B):
        diff = np.nonzero(tc[b] != td[b])[0]
        if len(diff):
            i = int(diff[0])
            require(margin[b, i] <= 10 * SERVE_SMALL_TOL * rms,
                    f"serve small: row {b} parts at step {i} with a top-2 "
                    f"margin {margin[b, i]}")
            near_ties += 1
    row = dict(step="small", arch=cfg.name, B=B, S=S, new_tokens=new,
               max_abs_err=err, logits_rms=rms, tol=SERVE_SMALL_TOL,
               rows_equal=B - near_ties, rows_parted_at_near_tie=near_ties)
    if cfg.n_experts:
        row.update(route_near_tie_tokens=ties, routes_parted=parts,
                   route_tie=ROUTE_TIE)
    log("serve " + json.dumps(row))
    return row


def run_serving(device, sizes=None, log=print) -> dict:
    """The serving phase: ``SERVE`` (or ``sizes`` over it) on ``device`` —
    generation at full width, CAMEO's KV selection (its kernel launches
    counted around ``prune_tree``), the float32 cache path, the reduced
    config card against CPU.  On the card the held lanes' CPU selection
    runs in a worker process started first."""
    device = torch.device(device)
    sz = dict(SERVE, **(sizes or {}))
    t0 = time.perf_counter()
    pool = None
    if device.type == "cuda":
        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(CPU_REF_THREADS,))
        pool.submit(_cpu_worker_init, CPU_REF_THREADS)
    try:
        cfg = (get_reduced if sz["reduced"] else get_config)(sz["arch"])
        if sz["attn_chunk"]:
            cfg = dataclasses.replace(cfg, attn_chunk=sz["attn_chunk"])
        t1 = time.perf_counter()
        params = init_params(model_defs(cfg), 0, device, cfg.pdtype())
        init_s = time.perf_counter() - t1
        gen, prompts, toks = _serve_generate(device, cfg, params, sz, init_s,
                                             log)
        sel, kernels, bf16 = _serve_prune(device, cfg, params, prompts, toks,
                                          sz, pool, log)
        cache, held = _serve_cache_path(device, cfg, params, sz, bf16, log)
        del params
        small = _serve_small(device, sz["arch"], sz, log)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    if device.type == "cuda":
        log("serve card " + nvidia_smi())
    return dict(rows=[gen, sel, held, cache, small],
                launches=sel["launches"],
                kernels=kernels, seconds=time.perf_counter() - t0)


# the MoE and Mamba2 families (``run_serving_zoo``): qwen3-moe-235b-a22b at
# its published width cut to ``layers`` layers (weights drawn on the card)
# for generation and the KV selection as ``SERVE``; its float32 cache path
# at one layer with capacity factor 8 (no drops); ``moe_apply_a2a`` against
# the scatter path on NCCL at world size 1 (``a2a_B`` x ``a2a_S`` tokens);
# mamba2-2.7b whole for generation and its float32 cache path (a prefill
# that ends inside a chunk); the reduced configs card against CPU
SERVE_MOE = dict(arch="qwen3-moe-235b-a22b", layers=4, attn_chunk=None,
                 B=8, S=2048, new=32,
                 keep=512, lags=16, held_layers=(0, -1), pruned_steps=8,
                 cache_B=2, cache_layers=1, cache_cf=8.0, cache_prefill=1024,
                 cache_steps=16, a2a_B=2, a2a_S=512)
SERVE_MAMBA = dict(arch="mamba2-2.7b", layers=None, B=8, S=2048, new=32,
                   cache_B=2, cache_prefill=1000, cache_steps=16)
SERVE_ZOO_SMALL = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "mamba2-2.7b",
                   "jamba-1.5-large-398b")
# a token's k-th and (k+1)-th router probabilities within this of each
# other are a near-tie: float32 sums in another order may swap them
ROUTE_TIE = 1e-5
# moe_apply_a2a against the scatter path: |diff| <= tol x RMS (the
# reference's own a2a bound, tests/test_dryrun_small.py:243-252)
SERVE_A2A_TOL = 1e-3


def _zoo_config(arch: str, layers, reduced: bool, **over):
    """``arch``'s published config (or its reduced one) cut to ``layers``
    blocks of its pattern (None: whole)."""
    cfg = (get_reduced if reduced else get_config)(arch)
    if layers is not None:
        n = layers // len(cfg.pattern)
        over = dict(n_blocks=n, n_layers=n * len(cfg.pattern),
                    remainder=(), **over)
    return dataclasses.replace(cfg, **over)


def _zoo_params(cfg, device, dtype=None):
    """``cfg``'s weights from seed 0, drawn on the card there (much faster
    than the CPU's draw, other values) and on the CPU here; returns
    (params, seconds)."""
    t0 = time.perf_counter()
    params = init_params(model_defs(cfg), 0, device, dtype or cfg.pdtype(),
                         draw="device" if device.type == "cuda" else "cpu")
    _sync(device)
    return params, time.perf_counter() - t0


@contextlib.contextmanager
def count_drops():
    """Within the block, every scatter-path MoE call appends (tokens a row,
    assignments the capacity drops) to the yielded list (a host read a
    call)."""
    got, orig = [], _moe.moe_apply

    def counting(p, x, spec):
        _, _, _, eidx = _moe.route(p, x, spec.top_k)
        C = _moe.capacity(x.shape[1], spec.top_k, spec.n_experts,
                          spec.capacity_factor)
        pos = _moe._positions_in_expert(eidx, spec.n_experts)
        got.append((x.shape[1], int(torch.sum(pos >= C)), C))
        return orig(p, x, spec)
    _moe.moe_apply = counting
    try:
        yield got
    finally:
        _moe.moe_apply = orig


def _serve_a2a(device, cfg, params, sz, log) -> dict:
    """``moe_apply_a2a`` on a (1, 1) mesh (NCCL on the card, gloo here) at
    ``cfg``'s width against the scatter path on the same layer and tokens,
    within ``SERVE_A2A_TOL`` x RMS."""
    import tempfile

    import torch.distributed as dist
    p = _index(params.tree()["blocks"], 0)["sub0"]["moe"]
    spec = layer_ctx(cfg, cfg.pattern[0])
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((sz["a2a_B"], sz["a2a_S"], cfg.d_model), generator=gen,
                    device=device, dtype=cfg.adtype())
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = _shd.mesh_2d(1, 1, device.type)
            with torch.inference_mode():
                want, aux_w = _moe.moe_apply(p, x, spec)
                t0 = time.perf_counter()
                got, aux = _moe_a2a.moe_apply_a2a(p, x, spec, mesh)
                _sync(device)
                wall = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    rms = float(torch.sqrt(torch.mean(want.double() ** 2)))
    err = float(torch.max(torch.abs(got - want)))
    require(err <= SERVE_A2A_TOL * rms,
            f"serve a2a: moe_apply_a2a parts from the scatter path by {err} "
            f"> {SERVE_A2A_TOL} x RMS {rms}")
    row = dict(step="moe_a2a", arch=cfg.name, world_size=1,
               backend="nccl" if device.type == "cuda" else "gloo",
               tokens=sz["a2a_B"] * sz["a2a_S"],
               capacity_factor=spec.capacity_factor, max_abs_err=err,
               rms=rms, tol=SERVE_A2A_TOL, aux=float(aux),
               aux_scatter=float(aux_w), seconds=wall)
    log("serve " + json.dumps(row))
    return row


def _serve_moe(device, sz, reduced: bool, pool, log) -> dict:
    """qwen3-moe at its width cut in depth: generation, the dropped
    assignments of each layer at prefill, the KV selection (its launches
    counted, the held layers equal to the CPU path), the float32 cache path
    and moe_apply_a2a at one layer."""
    chunk = dict(attn_chunk=sz["attn_chunk"]) if sz["attn_chunk"] else {}
    cfg = _zoo_config(sz["arch"], sz["layers"], reduced, **chunk)
    params, init_s = _zoo_params(cfg, device)
    gen, prompts, toks = _serve_generate(device, cfg, params, sz, init_s,
                                         log)
    with count_drops() as drops:
        sel, kernels, _ = _serve_prune(device, cfg, params, prompts, toks,
                                       sz, pool, log)
    pre = [(d, C) for S_, d, C in drops if S_ == sz["S"]]
    require(len(pre) == cfg.n_layers,
            f"serve moe: {len(pre)} MoE calls at prefill, "
            f"{cfg.n_layers} layers")
    gen["dropped_at_prefill"] = [d for d, _ in pre]
    gen["capacity"] = pre[0][1]
    gen["assignments_a_layer"] = sz["B"] * sz["S"] * cfg.top_k
    log("serve " + json.dumps(dict(step="moe_drops", arch=cfg.name,
                                   capacity=gen["capacity"],
                                   dropped_at_prefill=gen[
                                       "dropped_at_prefill"],
                                   assignments_a_layer=gen[
                                       "assignments_a_layer"])))
    for k in kernels:
        k["dataset"] = f"serving {sz['arch']}"
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg1 = _zoo_config(sz["arch"], sz["cache_layers"], reduced, **chunk,
                       capacity_factor=sz["cache_cf"],
                       param_dtype="float32", activ_dtype="float32")
    p1, _ = _zoo_params(cfg1, device)
    P, steps = sz["cache_prefill"], sz["cache_steps"]
    S_fwd = P + steps
    if cfg1.attn_chunk is not None:
        # the chunked forward takes whole chunks
        S_fwd = -(-S_fwd // cfg1.attn_chunk) * cfg1.attn_chunk
        require(S_fwd > cfg1.attn_chunk >= P,
                f"serve moe: forward over {S_fwd} must be chunked and "
                f"prefill over {P} not (attn_chunk {cfg1.attn_chunk})")
    cache = _decode_vs_forward(device, cfg1, p1, sz["cache_B"], S_fwd, P,
                               steps, log)
    a2a = _serve_a2a(device, cfg1, p1, sz, log)
    del p1
    return dict(rows=[gen, sel, cache, a2a], launches=sel["launches"],
                kernels=kernels)


def _serve_mamba(device, sz, reduced: bool, log) -> list:
    """mamba2-2.7b (whole): generation, then its float32 cache path."""
    cfg = _zoo_config(sz["arch"], sz["layers"], reduced)
    params, init_s = _zoo_params(cfg, device)
    gen, _, _ = _serve_generate(device, cfg, params, sz, init_s, log)
    P, steps = sz["cache_prefill"], sz["cache_steps"]
    require(P % cfg.mamba_chunk != 0,
            f"serve mamba: the prefill of {P} must end inside a chunk of "
            f"{cfg.mamba_chunk}")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activ_dtype="float32")
    params.float()
    cache = _decode_vs_forward(device, cfg32, params, sz["cache_B"],
                               P + steps, P, steps, log)
    return [gen, cache]


def run_serving_zoo(device, sizes=None, log=print) -> dict:
    """The MoE and Mamba2 phase (``SERVE_MOE``, ``SERVE_MAMBA``, each with
    ``sizes[arch]`` over it; ``sizes["reduced"]`` runs the reduced configs
    in their place): qwen3-moe generation, KV selection, float32 cache path
    and a2a; mamba2 generation and float32 cache path; the reduced
    ``SERVE_ZOO_SMALL`` configs card against CPU.  On the card the held
    lanes' CPU selection runs in a worker process started first."""
    device = torch.device(device)
    sizes = sizes or {}
    reduced = bool(sizes.get("reduced"))
    moe_sz = dict(SERVE_MOE, **sizes.get("moe", {}))
    mamba_sz = dict(SERVE_MAMBA, **sizes.get("mamba", {}))
    small_sz = dict(SERVE, **sizes.get("small", {}))
    t0 = time.perf_counter()
    pool = None
    if device.type == "cuda":
        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(CPU_REF_THREADS,))
        pool.submit(_cpu_worker_init, CPU_REF_THREADS)
    try:
        moe = _serve_moe(device, moe_sz, reduced, pool, log)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rows = moe["rows"] + _serve_mamba(device, mamba_sz, reduced, log)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for arch in SERVE_ZOO_SMALL:
        rows.append(_serve_small(device, arch, small_sz, log))
    if device.type == "cuda":
        log("serve zoo card " + nvidia_smi())
    return dict(rows=rows, launches=moe["launches"], kernels=moe["kernels"],
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the training phase: musicgen-large trained on a CAMEO-compressed series
# ---------------------------------------------------------------------------

# musicgen-large at its published width (configs/musicgen_large.py: 48
# layers, d 2,048, 32 heads of 64, d_ff 8,192, vocab 2,048, bfloat16,
# remat "full"), weights drawn on the card from seed 0, trained on uk_elec
# compressed by the port's compress() on the card: windows of S = 1,024
# tokens at stride 256, B = 8, one warm-up step and ``steps - 1`` timed
# ones (peak lr 3e-4, warmup 2, as launch/train.py sets them); the step
# with the stacked leaves read as views [i] for ``index_steps``; the
# reduced config card against a CPU worker for ``small_steps``; the
# reduced config's resume on the card; the launcher.
TRAIN = dict(arch="musicgen-large", reduced=False, series="uk_elec",
             length=None, B=8, S=1024, stride=256, steps=7, index_steps=3,
             peak_lr=3e-4, warmup=2, small_B=8, small_S=128,
             small_stride=64, small_steps=4, resume_steps=8,
             launcher_steps=3)
# the reduced config card against CPU (float32, the CPU draw on both
# sides, TF32 off): each step's loss within TRAIN_LOSS_TOL relative, every
# leaf after the last step within TRAIN_LEAF_TOL x the leaf's largest
# |value|.  The first reading (NVIDIA H100 80GB HBM3, 700 W): losses 8.1e-8
# relative (one float32 step), the worst leaf 3.9e-6 (blocks/sub0/mlp/wo)
# after 4 steps; the holds sit ~12x above them.
TRAIN_LOSS_TOL = 1e-6
TRAIN_LEAF_TOL = 5e-5
BF16_PEAK_FLOPS = 989e12    # H100 SXM bfloat16 dense, at the 700 W limit


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` within the block (an
    operation with no deterministic form raises and names itself)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def train_ops(cfg, B: int, S: int) -> dict:
    """Operations of one train step of an attention-only ``cfg`` on [B, S]
    tokens, counted from the config: 6 x the matrix parameters (the
    "linear" leaves: no embedding table, norm or bias) x tokens for the
    dense products (forward 2, backward 4), the attention's two
    S x S products a layer at 2 B S^2 H dh each (the port computes the
    whole square, in float32), backward twice the forward, and under
    ``remat="full"`` one more forward of the blocks."""
    mats = sum(math.prod(d.shape) for d in _def_leaves(model_defs(cfg))
               if d.init == "linear")
    lm = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab
    T = B * S
    attn_fwd = 2 * 2 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
    recompute = cfg.remat == "full"
    dense = 6 * mats * T + (2 * (mats - lm) * T if recompute else 0)
    attn = attn_fwd * (3 + (1 if recompute else 0))
    return dict(dense_bf16=dense, attention_f32=attn, total=dense + attn,
                bound_s=dense / BF16_PEAK_FLOPS + attn / FP32_FLOPS)


def _def_leaves(defs):
    if isinstance(defs, dict):
        for v in defs.values():
            yield from _def_leaves(v)
    else:
        yield defs


def train_windows(series: np.ndarray, recon: np.ndarray, vocab: int,
                  S: int, stride: int) -> np.ndarray:
    """The reconstruction's tokens (a codebook fit on the raw series) cut
    into windows of ``S``."""
    tok = SeriesTokenizer.fit(series, vocab)
    return series_windows(tok.encode(recon), window=S, stride=stride)


def _small_train_config(sz):
    cfg = get_reduced(sz["arch"])
    tcfg = TrainConfig(optimizer=default_train_config(cfg).optimizer,
                       peak_lr=sz["peak_lr"], warmup=sz["warmup"],
                       total_steps=sz["small_steps"])
    return cfg, tcfg


def train_small(device, windows: np.ndarray, sz) -> dict:
    """The reduced config (float32, the CPU draw) trained ``small_steps``
    steps on ``device``: each step's loss and every leaf after the last."""
    device = torch.device(device)
    cfg, tcfg = _small_train_config(sz)
    params = init_params(model_defs(cfg), 0, device)
    lcfg = LoopConfig(steps=sz["small_steps"], log_every=1)
    params, _, hist = train_loop(
        cfg, tcfg, lcfg, params, lambda step: forecast_batches(
            windows, sz["small_B"], step, device=device))
    return dict(losses=[h["loss"] for h in hist],
                leaves=_leaf_arrays(params))


def _leaf_arrays(tree) -> dict:
    return {"/".join(str(k) for k in path): t.detach().cpu().numpy()
            for path, t in leaves_with_path(tree)}


def _train_full(device, sz, windows, log) -> dict:
    """The full-width model's steps (the unbind form through
    ``train_loop``, then the [i] form), their times, losses and peak
    memory."""
    cfg = (get_reduced if sz["reduced"] else get_config)(sz["arch"])
    B, S, steps = sz["B"], sz["S"], sz["steps"]
    tcfg = TrainConfig(optimizer=default_train_config(cfg).optimizer,
                       peak_lr=sz["peak_lr"], warmup=sz["warmup"],
                       total_steps=steps)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params, init_s = _zoo_params(cfg, device)
    # a step's seconds: from one logged step to the next (the loop reads
    # each step's metrics, which waits for the card), the batch included
    marks = [time.perf_counter()]
    params, opt, hist = train_loop(
        cfg, tcfg, LoopConfig(steps=steps, log_every=1), params,
        lambda step: forecast_batches(windows, B, step, device=device),
        log_fn=lambda step, m: marks.append(time.perf_counter()))
    times = [float(t) for t in np.diff(marks)]
    loop_s = marks[-1] - marks[0]
    losses = [h["loss"] for h in hist]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"train: losses {losses} are not {steps} finite values")
    require(losses[-1] < losses[0],
            f"train: the loss did not fall ({losses[0]} -> {losses[-1]})")
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    # the stacked leaves read as views [i], on from the same state
    index_fn = build_train_step(cfg, tcfg, unbind=False)
    index_times, index_losses = [], []
    for i in range(sz["index_steps"]):
        t1 = time.perf_counter()
        params, opt, m = index_fn(params, opt, forecast_batches(
            windows, B, steps + i, device=device), steps + i)
        index_losses.append(float(m["loss"]))
        index_times.append(time.perf_counter() - t1)
    require(all(np.isfinite(index_losses)),
            f"train: the [i] form's losses {index_losses} are not finite")
    step_s = statistics.median(times[1:]) if len(times) > 1 else times[0]
    index_s = statistics.median(index_times[1:]) if len(index_times) > 1 \
        else index_times[0]
    ops = train_ops(cfg, B, S)
    row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               param_dtype=cfg.param_dtype, remat=cfg.remat,
               optimizer=tcfg.optimizer,
               params=count_params(model_defs(cfg)), B=B, S=S,
               windows=int(windows.shape[0]), init_s=init_s, steps=steps,
               losses=losses, step_s=times, median_step_s=step_s,
               tokens_per_s=B * S / step_s, loop_s=loop_s,
               max_memory_allocated=mem, ops=ops,
               share_of_bf16_peak=ops["total"] / step_s / BF16_PEAK_FLOPS,
               bound_share=ops["bound_s"] / step_s,
               index_step_s=index_times, index_median_step_s=index_s,
               index_losses=index_losses)
    del params, opt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def _train_resume(device, sz, windows, tmp: Path) -> dict:
    """The reduced config on ``device``: an unbroken ``resume_steps``-step
    loop against half of it with a checkpoint, a restore and the other
    half: every parameter and optimizer leaf and every loss bit-equal (the
    steps run deterministic)."""
    cfg, tcfg = _small_train_config(sz)
    n = sz["resume_steps"]
    tcfg = dataclasses.replace(tcfg, total_steps=n)
    p0 = init_params(model_defs(cfg), 1, device)

    def bfn(step):
        return forecast_batches(windows, sz["small_B"], step, device=device)
    with deterministic():
        pA, oA, hA = train_loop(cfg, tcfg, LoopConfig(steps=n, log_every=1),
                                copy.deepcopy(p0), bfn)
        half = LoopConfig(steps=n // 2, ckpt_dir=str(tmp), ckpt_every=n // 2,
                          log_every=1)
        _, _, h1 = train_loop(cfg, tcfg, half, copy.deepcopy(p0), bfn)
        pB, oB, h2 = train_loop(cfg, tcfg, dataclasses.replace(half, steps=n),
                                copy.deepcopy(p0), bfn)
    la, lb = [h["loss"] for h in hA], [h["loss"] for h in h1 + h2]
    pairs = list(zip(leaves((pA, oA)), leaves((pB, oB))))
    same = [torch.equal(a, b) for a, b in pairs]
    require(la == lb, f"train resume: losses {lb} != unbroken {la}")
    require(all(same), f"train resume: {same.count(False)} of {len(same)} "
                       f"leaves differ from the unbroken run")
    return dict(step="resume", arch=cfg.name, steps=n, resumed_at=n // 2,
                leaves=len(pairs), leaves_bit_equal=True, losses=la)


def run_training(device, sizes=None, log=print) -> dict:
    """The training phase (``TRAIN``, ``sizes`` over it): compress the
    series on ``device`` (its path's kernels counted), decompress, tokenize
    and window it; train the model at full width (a ``train {...}`` line:
    the compress, the losses, the step s, tokens/s, peak memory, the
    operations and their share of the bfloat16 peak, the [i] form's step);
    the reduced config card against a CPU worker started first; its resume
    bit-equal; the launcher.  Returns the rows, the compress's launches and
    the seconds."""
    device = torch.device(device)
    sz = dict(TRAIN, **(sizes or {}))
    t0 = time.perf_counter()
    cfg_c, kernels, _, x = _main_series(sz["series"], "rounds",
                                        sz["length"])
    _sync(device)
    reset_counts()
    tc = time.perf_counter()
    res = cameo.compress(x, cfg_c, device=device)
    xr = cameo.decompress(*cameo.kept_points(res), x.shape[0],
                          device=device).cpu().numpy()
    _sync(device)
    compress_s = time.perf_counter() - tc
    launches = read_counts()
    kept = res.kept.cpu().numpy()
    check_guarantee(f"train {sz['series']}", x, res.xr.cpu().numpy(), kept,
                    float(res.deviation), cfg_c)
    require(np.array_equal(xr, res.xr.cpu().numpy()),
            "train: decompress() differs from the compressor's "
            "reconstruction")
    if device.type == "cuda":
        for kname in kernels:
            require(launches[kname] > 0,
                    f"train: kernel {kname} was never launched by compress")
    comp = dict(series=sz["series"], n=int(x.shape[0]),
                cr=x.shape[0] / float(kept.sum()), wall_s=compress_s,
                launches={k: c for k, c in launches.items() if c})
    cfg_full = (get_reduced if sz["reduced"] else get_config)(sz["arch"])
    windows = train_windows(x, xr, cfg_full.vocab, sz["S"], sz["stride"])
    small_windows = train_windows(x, xr, get_reduced(sz["arch"]).vocab,
                                  sz["small_S"], sz["small_stride"])
    pool = ref = None
    if device.type == "cuda":
        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(CPU_REF_THREADS,))
        ref = pool.submit(train_small, "cpu", small_windows, sz)
    try:
        full = _train_full(device, sz, windows, log)
        full["compress"] = comp
        log("train " + json.dumps(full))
        card = train_small(device, small_windows, sz)
        cpu = ref.result() if ref is not None else card
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                               cpu["losses"])]
    leaf_err = {k: float(np.max(np.abs(card["leaves"][k].astype(np.float64)
                                       - v), initial=0.0))
                / max(float(np.max(np.abs(v), initial=0.0)), 1e-30)
                for k, v in cpu["leaves"].items()}
    worst = max(leaf_err, key=leaf_err.get)
    small = dict(step="card_vs_cpu", arch=get_reduced(sz["arch"]).name,
                 steps=sz["small_steps"], losses_card=card["losses"],
                 losses_cpu=cpu["losses"], loss_rel_err=max(rel),
                 loss_tol=TRAIN_LOSS_TOL, worst_leaf=worst,
                 worst_leaf_rel_err=leaf_err[worst], leaf_tol=TRAIN_LEAF_TOL)
    log("train " + json.dumps(small))
    require(max(rel) <= TRAIN_LOSS_TOL,
            f"train: card losses part from the CPU's by {max(rel)} relative")
    require(leaf_err[worst] <= TRAIN_LEAF_TOL,
            f"train: leaf {worst} parts from the CPU's by {leaf_err[worst]} "
            f"x its largest |value|")
    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        resume = _train_resume(device, sz, small_windows, Path(tmp))
    log("train " + json.dumps(resume))
    t1 = time.perf_counter()
    hist = _launch_train.main(["--arch", sz["arch"], "--reduced", "--steps",
                               str(sz["launcher_steps"]), "--device",
                               str(device)])
    require(len(hist) == sz["launcher_steps"]
            and all(np.isfinite(h["loss"]) for h in hist),
            f"train launcher: history {hist}")
    launcher = dict(step="launcher", steps=len(hist),
                    seconds=time.perf_counter() - t1,
                    losses=[h["loss"] for h in hist])
    log("train " + json.dumps(launcher))
    if device.type == "cuda":
        log("train card " + nvidia_smi())
    return dict(rows=[full, small, resume, launcher], launches=launches,
                seconds=time.perf_counter() - t0)


def _scan_state(device, name: str, rounds: int, length=None):
    """A scan run on ``device`` stepped ``rounds`` rounds (one lane): the
    config, the round functions' arguments, p0, the carry and the next
    round's ``small``."""
    cfg, _, _ = _path_cfg(name, "scan")
    x = make_dataset(name, seed=0, length=length)
    n = (x.shape[0] // cfg.kappa) * cfg.kappa
    nb = cameo._round_bucket(n, cfg)
    xp = F.pad(torch.from_numpy(x[:n]), (0, nb - n)).to(device)[None]
    nv = torch.full((1,), n, dtype=torch.int32, device=device)
    min_alive, eps = cameo._halting_params(n, cfg)
    consts = (torch.full((1,), min_alive, dtype=torch.int32, device=device),
              torch.full((1,), eps, dtype=cfg.tdtype(), device=device))
    carry, p0 = cameo._rounds_init(xp, nv, cfg)
    probe, body = cameo._round_fns(cfg, nb, nv, *consts, p0)
    for _ in range(rounds):
        ((go, small),) = probe(carry).tolist()
        require(go, f"{name} scan ended before the lock-step round")
        carry = body(carry, small=small)
    ((go, small),) = probe(carry).tolist()
    require(go, f"{name} scan ended before the lock-step round")
    return cfg, (nb, nv, *consts, p0), carry, small


@contextlib.contextmanager
def card_dispatch(device):
    """On the CPU, dispatch the scan as on the card (its greedy branch, with
    every kernel wrapper taking its plain version for CPU tensors), so the
    card's path is rehearsed; nothing changes on the card."""
    if device.type == "cuda":
        yield
        return
    saved = _ops._kernel_eligible
    _ops._kernel_eligible = lambda backend, stat, measure, device=None: (
        stat == "acf" and measure in _ref.KERNEL_MEASURES)
    try:
        yield
    finally:
        _ops._kernel_eligible = saved


def capture_round(device, name: str, rounds: int = 3, length=None) -> dict:
    """The arguments of the prefix walk of the scan's lock-step round
    (round ``rounds``, after that many rounds on ``device``), captured
    through the round body's ``prefix_devs_fn`` hook: ``args`` is (y, dyws,
    ystarts, ok, table, p0, ny, eps) of the run's one lane."""
    device = torch.device(device)
    got = {}

    def recording(*a, **kw):
        got.setdefault("args", tuple(t[0].clone() for t in a))
        return _fused.prefix_devs_cuda(*a, **kw)
    with card_dispatch(device):
        cfg, fargs, carry, small = _scan_state(device, name, rounds, length)
        _, body = cameo._round_fns(cfg, *fargs, prefix_devs_fn=recording)
        body(carry, small=small)
    require("args" in got, f"{name} scan round {rounds} walked no prefix")
    return dict(round=rounds, args=got["args"])


def scan_lockstep(device, name: str = "uk_elec", rounds: int = 3) -> dict:
    """One scan round from one carry on the card, twice: the greedy branch
    with the prefix_devs kernel and with its plain version.  Their take
    masks (ok & devs <= eps) must be identical, and so the carries."""
    device = torch.device(device)
    cfg, fargs, carry, small = _scan_state(device, name, rounds)
    takes, outs = {}, {}
    for key, fn in (("kernel", _fused.prefix_devs_cuda),
                    ("plain", _fused.prefix_devs_plain)):
        def recording(*a, _fn=fn, _key=key, **kw):
            devs = _fn(*a, **kw)
            takes[_key] = (a[3] & (devs <= a[7][:, None])).cpu()
            return devs
        _, body_k = cameo._round_fns(cfg, *fargs, prefix_devs_fn=recording)
        outs[key] = body_k(carry, small=small)
    require(torch.equal(takes["kernel"], takes["plain"]),
            f"{name} lock-step scan round: the kernel's take mask differs "
            f"from the plain version's in "
            f"{int(torch.sum(takes['kernel'] != takes['plain']))} ranks")
    same = all(torch.equal(a, b) for a, b in zip(outs["kernel"],
                                                  outs["plain"]))
    require(same, f"{name} lock-step scan round: the carries differ")
    return dict(dataset=name, round=rounds, ranks=int(takes["kernel"].numel()),
                taken=int(takes["kernel"].sum()), takes_equal=True,
                carries_equal=same)


def run_phases(device, *, uk_length=None, aus_length=None,
               seq_lengths=None, seq_full=(), cpu_check: bool = True,
               batches=BATCHES, kernel_lanes=None,
               prefix_lanes: int = PREFIX_LANES, mv_columns: int = MV_COLUMNS,
               streams=STREAMS, stream_mv=(STREAM_MV_COLUMNS, 17520, 4096),
               log=print) -> dict:
    """Phases 3-4 on ``device``: each kernel against its plain version at
    both datasets' shapes, one series and lanes (``kernel_lanes``, default
    ``KERNEL_LANES``), then the main paths on uk_elec and aus_elec (rounds
    and scan at ``uk_length``/``aus_length``, default full; sequential at
    ``seq_lengths``, default ``SEQ_LENGTHS``, and at the (dataset, length)
    pairs of ``seq_full`` without the CPU run), then the batch phase
    (``batches`` and ``compress_multivariate`` of ``mv_columns`` columns,
    at the same lengths), then the streaming phase (``streams`` and the
    multivariate ``stream_mv``).  On the card the main paths' CPU runs
    start first, in worker processes (``cpu_references``), and run
    beside the kernel phases.  Returns the report."""
    device = torch.device(device)
    lengths = dict(zip(DATASETS, (uk_length, aus_length)))
    seq_lengths = seq_lengths or SEQ_LENGTHS
    kernel_lanes = kernel_lanes or KERNEL_LANES
    main_jobs = [(name, path, seq_lengths[name] if path == "sequential"
                  else lengths[name]) for path in PATHS for name in DATASETS]
    pool, refs = cpu_references(main_jobs) \
        if cpu_check and device.type == "cuda" else (None, {})
    try:
        seconds = {}
        t0 = time.perf_counter()
        kernels = []
        for name in DATASETS:
            kernels += phase_kernels(device, name, lengths[name])
        seconds["kernels"] = time.perf_counter() - t0
        for name in DATASETS:
            kernels += phase_kernels_lanes(
                device, name, kernel_lanes[name], lengths[name],
                prefix_lanes=prefix_lanes if name == "uk_elec" else 0)
        seconds["kernels_lanes"] = time.perf_counter() - t0 - seconds["kernels"]
        for k in kernels:
            log(f"kernel {k['name']} {k['dataset']} [{k['shape']}] max_abs_err="
                f"{k['max_abs_err']:.3e} tol rtol {TOL[k['name']][0]} + "
                f"{TOL[k['name']][1]} x max|plain| ms={k['ms']} "
                f"plain_ms={k['plain_ms']} library_ms={k['library_ms']} "
                f"bound_ms={k['bound_ms']:.3e} ({k['bound_by']})")
        floor = launch_floor_ms(device)
        log(f"launch_floor ms={floor} (an empty kernel, built and bound as the "
            f"port's kernels are)")
        runs = []
        counted = dict(launches=dict.fromkeys(WRAPPERS, 0), by_path={})
        t0 = time.perf_counter()
        # the card-only runs first, while the CPU runs go on beside them
        card_only = []
        for name, n in seq_full:
            row = phase_main(device, name, "sequential", n, cpu_check=False)
            add_launches(counted, "sequential", row["launches"])
            card_only.append(row)
            log("main " + json.dumps(row))
        for path in PATHS:
            for name in DATASETS:
                length = seq_lengths[name] if path == "sequential" \
                    else lengths[name]
                row = phase_main(device, name, path, length,
                                 cpu_check=cpu_check,
                                 cpu_ref=refs.get((name, path)))
                add_launches(counted, path, row["launches"])
                runs.append(row)
                log("main " + json.dumps(row))
        runs += card_only
        by = {(r["dataset"], r["path"]): r for r in runs}
        for name in DATASETS:
            # the scan's CR beside the card's backoff CR
            by[(name, "scan")]["cr_backoff"] = by[(name, "rounds")]["cr"]
        seconds["main_paths"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch_rows = []
        for name, B, held in batches:
            row = phase_batch(device, name, B, held, lengths[name])
            row["path"] = "batch"
            batch_rows.append(row)
            log("batch " + json.dumps(row))
        if mv_columns:
            row = phase_multivariate(device, "uk_elec", mv_columns,
                                     lengths["uk_elec"])
            row["path"] = "multivariate"
            batch_rows.append(row)
            log("multivariate " + json.dumps(row))
        for row in batch_rows:
            add_launches(counted, row["path"], row["launches"])
        seconds["batch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reset_counts()
        stream = run_streams(device, streams=streams, mv=stream_mv,
                             cpu_check=cpu_check, log=log)
        for row in stream["rows"]:
            for r in (row.get("depths") or {}).values():
                add_launches(counted, "stream", r["launches"])
            add_launches(counted, "stream", row.get("launches") or {})
        seconds["stream"] = time.perf_counter() - t0
        return dict(kernels=kernels, runs=runs, batches=batch_rows,
                    streams=stream, launch_floor_ms=floor, seconds=seconds,
                    **counted)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


def kernel_rows(report, names=tuple(WRAPPERS)) -> list:
    """The ``{"kernels": [...]}`` rows of the kernels ``names`` (every
    kernel by default): one per kernel, timed at the first dataset's
    shapes, with every dataset's check and times under ``shapes``;
    ``max_abs_err`` is the largest over all of them.  Fails where the
    report holds no entry of one of them."""
    rows = []
    by_path = report.get("by_path", {})
    for name in names:
        ks = [k for k in report["kernels"] if k["name"] == name]
        require(ks, f"kernel {name} has no phase-3 entry")
        first = ks[0]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=report["launches"][name],
            launches_by_path={path: c[name] for path, c in by_path.items()
                              if c.get(name)},
            max_abs_err=max(k["max_abs_err"] for k in ks), ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
            shapes=[{key: k[key] for key in (
                "dataset", "shape", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "pair_ms", "wall_ms",
                "pair_wall_ms") if key in k} for k in ks]))
    return rows


def add_launches(report, path: str, counts: dict) -> None:
    """Add a phase's launch counts to ``report``'s totals and to its
    ``by_path[path]``."""
    mine = report["by_path"].setdefault(path, dict.fromkeys(WRAPPERS, 0))
    for kname, c in counts.items():
        report["launches"][kname] += c
        mine[kname] += c


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    # cuBLAS's fixed workspace, which the training phase's deterministic
    # resume needs; set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(nvidia_smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    info = _build.build_all()
    print(f"build: {info['seconds']:.1f} s")
    for stem, log in sorted(info["logs"].items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    # uk_elec's sequential run over its whole year too: ~4 ms of host
    # dispatch a pop on the card, so its CPU twin is left to the
    # 4,096-point run
    seconds = {"build": info["seconds"]}
    t0 = time.perf_counter()
    report = run_phases(device, seq_full=(("uk_elec", SEQ_FULL_YEAR),))
    seconds.update(report["seconds"])
    for r in report["runs"]:
        print("path " + json.dumps({k: r.get(k) for k in (
            "dataset", "path", "n", "iters", "iters_cpu", "cr", "cr_cpu",
            "cr_backoff", "same_kept", "deviation_bits_equal", "wall_s",
            "s_per_iter",
            "launches_per_iter", "wall_s_cpu")}))
    for r in report["batches"]:
        keys = (("dataset", "B", "n", "rounds", "iters_min", "cr_mean",
                 "wall_s", "loop_wall_s", "lanes_held",
                 "deviations_bit_equal", "launches_per_round",
                 "max_memory_allocated") if r["path"] == "batch" else
                ("dataset", "C", "n", "iters", "cr", "col_n_kept",
                 "deviations", "wall_s", "max_memory_allocated"))
        print(r["path"] + " " + json.dumps({k: r.get(k) for k in keys}))
    for r in report["streams"]["rows"]:
        print("stream " + json.dumps({k: r.get(k) for k in (
            "case", "n", "window", "windows", "tail", "tail_iters", "cr",
            "cr_cpu", "windows_same_kept_as_cpu", "deviation", "store_bytes",
            "wall_s", "points_per_s", "depths", "max_memory_allocated")}))
    print("stream counters " + json.dumps(report["streams"]["counters"]))
    # the baselines phase's CPU references start now, beside the facade and
    # partitioned phases (the main paths' CPU pool has finished)
    bl_pool, bl_refs = baseline_references(DATASETS[0])
    try:
        bl = run_more_phases(device, report, seconds, bl_refs)
    finally:
        bl_pool.shutdown(wait=True, cancel_futures=True)
    print("baselines " + json.dumps(dict(
        launches=bl["launches"], lossless=bl["lossless"],
        simpiece_host_s=bl["simpiece_host_s"], seconds=bl["seconds"],
        seconds_with_holds=bl["seconds_with_holds"])))
    srv = run_serving(device)
    seconds["serving"] = srv["seconds"]
    zoo = run_serving_zoo(device)
    seconds["serving_zoo"] = zoo["seconds"]
    for part in (srv, zoo):
        add_launches(report, "serving_selection", part["launches"])
        report["kernels"] += part["kernels"]
    train = run_training(device)
    seconds["training"] = train["seconds"]
    add_launches(report, "training", train["launches"])
    for path in SEGMENT_CELLS_PATHS:
        require(report["by_path"].get(path, {}).get("segment_cells", 0) > 0,
                f"segment_cells was never launched on the {path} path")
    print(nvidia_smi())
    t0 = time.perf_counter()
    print("lockstep " + json.dumps(scan_lockstep(device)))
    seconds["lockstep"] = time.perf_counter() - t0
    print("seconds " + json.dumps(seconds))

    print(json.dumps({"kernels": kernel_rows(report)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_more_phases(device, report, seconds, bl_refs) -> dict:
    """The facade, partitioned and baselines phases after ``run_phases``:
    their launches go into ``report``'s totals, the baselines' segment_scan
    holds into its kernel entries, their seconds into ``seconds``."""
    facade = run_facade(device)
    seconds["facade"] = facade["seconds"]
    add_launches(report, "facade", facade["launches"])
    print("facade " + json.dumps(dict(steps=facade["steps"],
                                      launches=facade["launches"],
                                      seconds=facade["seconds"])))
    part = run_partitioned(device)
    seconds["partitioned"] = part["seconds"]
    add_launches(report, "partitioned", part["launches"])
    bl = run_baselines(device, refs=bl_refs)
    seconds["baselines"] = bl["seconds"]
    seconds["segment_scan_holds"] = bl["seconds_with_holds"] - bl["seconds"]
    add_launches(report, "baselines", bl["launches"])
    report["kernels"] += bl["kernels"]
    for k in bl["kernels"]:
        print(f"kernel {k['name']} {k['dataset']} [{k['shape']}] "
              f"max_abs_err={k['max_abs_err']:.3e} tol 0 ms={k['ms']} "
              f"plain_ms={k['plain_ms']} library_ms=None "
              f"bound_ms={k['bound_ms']:.3e} ({k['bound_by']})")
    return bl


if __name__ == "__main__":
    sys.exit(main())
