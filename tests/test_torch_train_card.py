"""The training slice on the card against the CPU, and
``chip_smoke.run_training`` rehearsed tiny on the CPU.

This file imports no JAX: its ``gpu`` test (skipped without a card) holds
one train step of the reduced musicgen config on the card to the same
step on the CPU.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.data.pipeline import token_batch
from repro_torch.models.model import model_defs
from repro_torch.models.params import init_params
from repro_torch.train import step as tstep
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(reduced=True, length=2048, B=2, S=32, stride=16, steps=3,
            index_steps=2, small_B=2, small_S=32, small_stride=16,
            small_steps=2, resume_steps=4, launcher_steps=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chip_smoke_training_rehearsal():
    """chip_smoke.py's training phase at a tiny size on the CPU, where
    every wrapper takes its plain version: uk_elec's first 2,048 points
    compressed, windows of 32, musicgen-large reduced for 3 steps and 2 in
    the [i] form, the card-against-CPU hold (the CPU against itself here),
    the resume bit-equal, the launcher; no kernel is counted."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    lines = []
    out = chip_smoke.run_training("cpu", sizes=TINY, log=lines.append)
    full, small, resume, launcher = out["rows"]
    assert full["arch"] == "musicgen-large-reduced"
    assert len(full["losses"]) == 3 and full["losses"][-1] < full["losses"][0]
    assert len(full["index_losses"]) == 2
    assert full["compress"]["cr"] > 1 and full["compress"]["n"] == 2048
    assert full["ops"]["total"] == full["ops"]["dense_bf16"] + \
        full["ops"]["attention_f32"] > 0
    assert small["loss_rel_err"] == 0.0 and small["worst_leaf_rel_err"] == 0
    assert resume["leaves_bit_equal"] and resume["steps"] == 4
    assert launcher["steps"] == 2
    assert sum(out["launches"].values()) == 0
    assert [ln.split()[0] for ln in lines] == ["train"] * 4


def test_train_ops_counts_musicgen_large():
    """The operations of a full-width step, counted from the config: the
    matrix parameters (all but the embedding table and the norms: ~2.42 B
    at musicgen-large) x 6 x tokens, the recompute of remat "full", and
    the attention's float32 squares."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    cfg = chip_smoke.get_config("musicgen-large")
    ops = chip_smoke.train_ops(cfg, 8, 1024)
    T, d, L = 8 * 1024, 2048, 48
    mats = L * (4 * d * d + 2 * d * 8192) + d * 2048
    assert ops["dense_bf16"] == 6 * mats * T + 2 * (mats - d * 2048) * T
    assert ops["attention_f32"] == 4 * 4 * 8 * 1024 ** 2 * d * L
    assert 1.5e14 < ops["dense_bf16"] < 1.7e14


@pytest.mark.gpu
def test_gpu_train_step_equals_cpu():
    """One train step of musicgen-large reduced (float32, the CPU draw) on
    the card and on the CPU: the loss within 1e-6 relative and every
    parameter within 5e-5 x its leaf's largest |value| (chip_smoke's
    card-against-CPU holds, ``TRAIN_LOSS_TOL`` and ``TRAIN_LEAF_TOL``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("musicgen-large")
    tt = tstep.TrainConfig(peak_lr=1e-3, warmup=2, total_steps=10)
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(model_defs(cfg), 0, dev)
        params.requires_grad_(True)
        batch = token_batch(cfg, 4, 64, 0, device=dev)
        opt = tstep.init_opt_state(params, tt)
        params, opt, m = tstep.build_train_step(cfg, tt)(params, opt, batch,
                                                         0)
        out[dev] = (float(m["loss"]),
                    {"/".join(map(str, k)): v.detach().cpu().double().numpy()
                     for k, v in leaves_with_path(params)})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-6)
    for k, w in out["cpu"][1].items():
        scale = max(float(np.max(np.abs(w))), 1e-30)
        assert float(np.max(np.abs(out["cuda"][1][k] - w))) <= 5e-5 * scale, k
