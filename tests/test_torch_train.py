"""The port's train step, loop and launcher (``repro_torch.train``,
``launch.train``) against the JAX package's, on the CPU.

One ``build_train_step`` step, AdamW (musicgen-large and qwen3-0.6b
reduced) and Adafactor (qwen3-moe reduced, factored from 16 rows so its
matrices take the factored form), at one and two microbatches, from the
reference's weights and, for the second step, the reference's optimizer
state carried across (``convert.opt_state_from_numpy``): the metrics, the
optimizer state and every parameter.  Then the model's training forms
(remat none / full / dots, the ``unbind`` and ``[i]`` forms: bit-equal),
Mamba's gradients at a 256-point chunk (C21), and the port's counterparts
of the reference's ``tests/test_train_loop.py`` (loss decreases; resume
bit-equal, not within 1e-5) and ``test_lm_trains_on_cameo_compressed_series``
(the port's own ``compress()`` on the CPU), and the launcher.

Tolerances: metrics within 2e-5 relative (the loss) and 1e-4 (the
gradient norm); the optimizer state within ``STATE_TOL`` x the leaf's
largest |value|; parameters within ``STEP_TOL`` x the leaf's largest
|value|, except where the reference's gradient is below 1e-3 x the
leaf's largest |g|: there AdamW's first steps move by ~lr x sign(g) and a
sign of a near-zero gradient may differ (the gradients agree within 5e-5
x the leaf's largest, ``test_torch_train_grads.py``), so those move by at
most 2 lr + the tolerance.
"""
import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.pipeline import token_batch as j_token_batch
from repro.models import model as jm
from repro.models.params import init_params as jinit
from repro.optim.adafactor import AdafactorConfig as JAdafactorConfig
from repro.train import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy)
from repro_torch.core import cameo as tcameo
from repro_torch.data.pipeline import (SeriesTokenizer, series_windows,
                                       token_batch)
from repro_torch.data.synthetic import make_dataset
from repro_torch.models import model as tm
from repro_torch.models.params import init_params
from repro_torch.optim.adafactor import AdafactorConfig
from repro_torch.train import step as tstep
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.tree import leaves, leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 32
STATE_TOL = 1e-4
STEP_TOL = 1e-5
SIGN_FLOOR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jkey(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_jkey(p): np.asarray(np.asarray(v), np.float64) for p, v in flat}


def _tflat(tree) -> dict:
    return {"/".join(str(k) for k in p): v.detach().double().numpy()
            for p, v in leaves_with_path(tree)}


def _scale(w) -> float:
    return max(float(np.max(np.abs(w))), 1e-30) if w.size else 1.0


def _held_params(got: dict, want: dict, grads: dict, lr: float):
    assert set(got) == set(want)
    for k, w in want.items():
        d = np.abs(got[k] - w)
        tol = STEP_TOL * _scale(w)
        unstable = np.abs(grads[k]) <= SIGN_FLOOR * _scale(grads[k])
        bad = (d > tol) & ~(unstable & (d <= 2 * lr + tol))
        assert not bad.any(), (k, float(d.max()), tol, int(bad.sum()))


def _held_state(got, want):
    g, w = _tflat(got), _jflat(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert float(np.max(np.abs(g[k] - w[k]), initial=0.0)) <= \
            STATE_TOL * _scale(w[k]), k


STEP_CASES = (("musicgen-large", "adamw", 1), ("musicgen-large", "adamw", 2),
              ("qwen3-0.6b", "adamw", 1), ("qwen3-moe-235b-a22b",
                                           "adafactor", 2))


@pytest.mark.parametrize("arch,opt,nm", STEP_CASES)
def test_train_step_matches_reference(arch, opt, nm):
    jcfg, tcfg_m = jreg.get_reduced(arch), treg.get_reduced(arch)
    common = dict(optimizer=opt, peak_lr=1e-3, warmup=2, total_steps=10,
                  num_microbatches=nm)
    jt = jstep.TrainConfig(**common,
                           adafactor=JAdafactorConfig(min_dim_factored=16))
    tt = tstep.TrainConfig(**common,
                           adafactor=AdafactorConfig(min_dim_factored=16))
    jp = jinit(jm.model_defs(jcfg), jax.random.PRNGKey(2))
    jopt = jstep.init_opt_state(jp, jt)
    jfn = jax.jit(jstep.build_train_step(jcfg, jt))
    tfn = tstep.build_train_step(tcfg_m, tt)
    jbs = [j_token_batch(jcfg, B, S, step=i) for i in range(2)]
    # step 0 from the same weights; step 1 from the reference's step-0
    # weights and optimizer state, carried across
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg_m, "cpu")
    tp.requires_grad_(True)
    topt = tstep.init_opt_state(tp, tt)
    for i, jb in enumerate(jbs):
        if i:
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg_m,
                                   "cpu")
            tp.requires_grad_(True)
            topt = opt_state_from_numpy(jax.tree.map(np.asarray, jopt),
                                        "cpu")
        jg = jax.jit(jax.grad(lambda p, b: jstep.loss_fn(
            p, jcfg, jt, b)[0]))(jp, jb)
        jp, jopt, jm_ = jfn(jp, jopt, jb, jnp.asarray(i))
        tb = {k: torch.from_numpy(np.array(v, copy=True))
              for k, v in jb.items()}
        tp, topt, tm_ = tfn(tp, topt, tb, i)
        assert float(tm_["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-7)
        assert float(tm_["loss"]) == pytest.approx(float(jm_["loss"]),
                                                   rel=2e-5)
        assert float(tm_["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=1e-4, abs=1e-12)
        assert int(topt.step) == int(jopt.step) == i + 1
        _held_params(_tflat(tp), _jflat(jp), _jflat(jg), float(jm_["lr"]))
        _held_state(topt[:2], jopt[:2])
    back = opt_state_to_numpy(topt)
    assert type(back).__name__ == type(jopt).__name__
    assert back.step.dtype == np.int32


@pytest.mark.parametrize("arch", ("musicgen-large", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b"))
def test_remat_and_unbind_forms_are_bit_equal(arch, monkeypatch):
    """remat none / full / dots and the ``[i]`` form give the same loss and
    gradients bit for bit; ``full`` saves fewer tensors for the backward
    than ``none`` (counted by a ``saved_tensors_hooks``); ``dots`` keeps
    at least one 2-D product a layer (its policy's decisions counted) and
    recomputes every batched product."""
    cfg0 = treg.get_reduced(arch)
    params = init_params(tm.model_defs(cfg0), 1, "cpu")
    params.requires_grad_(True)
    batch = token_batch(cfg0, 2, 16, 0, device="cpu")
    tt = tstep.TrainConfig()
    plist = leaves(params)
    decisions = []
    policy = tm._save_dots

    def spy(ctx, op, *a, **kw):
        got = policy(ctx, op, *a, **kw)
        decisions.append((op, tuple(getattr(a[0], "shape", ())), got))
        return got
    monkeypatch.setattr(tm, "_save_dots", spy)
    out, saved = {}, {}
    for form in ("none", "full", "dots", "index"):
        cfg = dataclasses.replace(cfg0, remat="none" if form == "index"
                                  else form)
        count = [0]

        def pack(t, count=count):
            count[0] += 1
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tot, _ = tstep.loss_fn(params, cfg, tt, batch,
                                   unbind=form != "index")
        saved[form] = count[0]
        out[form] = (tot.detach(), torch.autograd.grad(tot, plist))
    for form in ("full", "dots", "index"):
        assert torch.equal(out[form][0], out["none"][0]), form
        assert all(torch.equal(a, b) for a, b in zip(out[form][1],
                                                      out["none"][1])), form
    assert saved["full"] < saved["none"], saved
    kept = [d for d in decisions
            if d[2] == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    assert len(kept) >= cfg0.n_layers
    bmm = torch.ops.aten.bmm.default
    assert all(d[2] != torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
               for d in decisions if d[0] == bmm and d[1][0] > 1)


def test_mamba_grads_finite_at_long_chunk():
    """mamba2's chunked scan at a 256-point chunk, where the reference's
    ``exp(diff) * causal`` overflows to NaN (C21): the port's mask to -inf
    before ``exp`` gives finite gradients."""
    cfg = dataclasses.replace(treg.get_reduced("mamba2-2.7b"),
                              mamba_chunk=256)
    params = init_params(tm.model_defs(cfg), 0, "cpu")
    params.requires_grad_(True)
    batch = token_batch(cfg, 1, 256, 0, device="cpu")
    tot, _ = tstep.loss_fn(params, cfg, tstep.TrainConfig(), batch)
    gs = torch.autograd.grad(tot, leaves(params))
    assert torch.isfinite(tot)
    assert all(bool(torch.isfinite(g).all()) for g in gs)


def _structured_batch_fn(batch, seq):
    """The reference's learnable task: tokens follow a cyclic pattern."""
    def fn(step):
        rng = np.random.default_rng(step % 7)
        base = (np.arange(seq) + rng.integers(0, 8)) % 32
        return {"tokens": torch.from_numpy(
            np.tile(base, (batch, 1)).astype(np.int32))}
    return fn


def test_loss_decreases():
    cfg = treg.get_reduced("smollm-135m")
    params = init_params(tm.model_defs(cfg), 0, "cpu")
    tt = tstep.TrainConfig(peak_lr=3e-3, warmup=5, total_steps=60,
                           z_loss=0.0)
    _, _, hist = train_loop(cfg, tt, LoopConfig(steps=60, log_every=5),
                            params, _structured_batch_fn(4, 32))
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.7


def test_resume_is_bit_consistent(tmp_path):
    """An interrupted-then-resumed run equals the unbroken one bit for bit:
    parameters, optimizer state and every loss."""
    cfg = treg.get_reduced("qwen3-0.6b")
    params0 = init_params(tm.model_defs(cfg), 1, "cpu")
    tt = tstep.TrainConfig(peak_lr=1e-3, warmup=2, total_steps=20,
                           z_loss=0.0)
    bfn = _structured_batch_fn(2, 32)
    pA, oA, hA = train_loop(cfg, tt, LoopConfig(steps=20, log_every=1),
                            copy.deepcopy(params0), bfn)
    d = str(tmp_path / "ck")
    _, _, h1 = train_loop(cfg, tt, LoopConfig(steps=10, ckpt_dir=d,
                                              ckpt_every=10, log_every=1),
                          copy.deepcopy(params0), bfn)
    pB, oB, h2 = train_loop(cfg, tt, LoopConfig(steps=20, ckpt_dir=d,
                                                ckpt_every=10, log_every=1),
                            copy.deepcopy(params0), bfn)
    assert [h["loss"] for h in h1 + h2] == [h["loss"] for h in hA]
    for a, b in zip(leaves((pA, oA)), leaves((pB, oB))):
        assert torch.equal(a, b)


def test_lm_trains_on_cameo_compressed_series():
    """The port's counterpart of the reference's end-to-end test: the
    port's ``compress()`` on elec_power (seed 1, 2,976 points), decompress,
    tokenize against the raw series, windows of 32, and 8 steps of
    musicgen-large reduced: finite losses that fall."""
    x = make_dataset("elec_power", seed=1, length=2976)
    res = tcameo.compress(torch.from_numpy(x), tcameo.CameoConfig(
        eps=1e-2, lags=48, dtype="float64"), device="cpu")
    idx, vals = tcameo.kept_points(res)
    recon = tcameo.decompress(idx, vals, len(x), device="cpu").numpy()
    cfg = treg.get_reduced("musicgen-large")
    tok = SeriesTokenizer.fit(x, vocab=cfg.vocab)
    windows = series_windows(tok.encode(recon), window=32, stride=16)
    params = init_params(tm.model_defs(cfg), 0, "cpu")
    params.requires_grad_(True)
    tt = tstep.TrainConfig(peak_lr=1e-3, warmup=2, total_steps=10, z_loss=0.0)
    step = tstep.build_train_step(cfg, tt)
    opt = tstep.init_opt_state(params, tt)
    losses = []
    for i in range(8):
        batch = {"tokens": torch.from_numpy(windows[i * 4:(i + 1) * 4])}
        params, opt, m = step(params, opt, batch, i)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_launch_train_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "musicgen-large", "--device", "cpu", "--steps", "3", "--seq", "32",
         "--batch", "2"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 3
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)

