"""The port's training loss and its gradients (``repro_torch.train.step``
over ``models.model.forward`` with grad enabled) against the JAX
package's, on the CPU.

``next_token_loss`` with and without z-loss, then all ten reduced configs
(float32, B = 2, S = 32), the reference's weights carried across with
``convert.params_from_numpy``: ``loss_fn``'s value and every leaf's
gradient against ``jax.value_and_grad`` (the MoE aux loss through the
capacity buffer's scatter and gather, Mamba's chunked scan with C21's
mask, M-RoPE with patch embeddings, tied embeddings).  The step, loop and
launcher are in ``test_torch_train.py``.

Tolerances: the loss within 2e-5 relative; each gradient leaf within
``GRAD_TOL`` x that leaf's largest |g| of the reference's (float32 sums in
two frameworks' orders through 2-8 layers and their backward; the worst
leaf measured 9.8e-6, mamba2's ``A_log``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.pipeline import token_batch as j_token_batch
from repro.models import model as jm
from repro.models.params import init_params as jinit
from repro.train import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_numpy
from repro_torch.train import step as tstep
from repro_torch.tree import leaves_with_path

ALL_ARCHS = ("stablelm-12b", "gemma3-27b", "qwen3-0.6b", "smollm-135m",
             "qwen2-vl-2b", "musicgen-large", "qwen3-moe-235b-a22b",
             "kimi-k2-1t-a32b", "mamba2-2.7b", "jamba-1.5-large-398b")
B, S = 2, 32
LOSS_TOL = 2e-5
GRAD_TOL = 5e-5
STEP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch, seed=0, **over):
    jcfg = dataclasses.replace(jreg.get_reduced(arch), **over)
    tcfg = dataclasses.replace(treg.get_reduced(arch), **over)
    jp = jinit(jm.model_defs(jcfg), jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tp.requires_grad_(True)
    jb = j_token_batch(jcfg, B, S, step=0)
    tb = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in jb.items()}
    return jcfg, tcfg, jp, tp, jb, tb


def _jkey(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _by_key(tree, jax_tree: bool) -> dict:
    if jax_tree:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {_jkey(p): np.asarray(v, np.float64) for p, v in flat}
    return {"/".join(str(k) for k in p): v.detach().double().numpy()
            for p, v in leaves_with_path(tree)}


def _leaf_err(got: dict, want: dict) -> dict:
    """{key: max |got - want| / max |want|} over matching keys."""
    assert set(got) == set(want)
    out = {}
    for k, w in want.items():
        scale = max(float(np.max(np.abs(w))), 1e-30) if w.size else 1.0
        out[k] = float(np.max(np.abs(got[k] - w))) / scale if w.size else 0.0
    return out


@pytest.mark.parametrize("z", (0.0, 1e-4))
def test_next_token_loss_matches_reference(z):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 4
    toks = rng.integers(0, 50, (2, 9)).astype(np.int32)
    want = float(jstep.next_token_loss(jnp.asarray(logits), jnp.asarray(toks),
                                       z))
    got = float(tstep.next_token_loss(torch.from_numpy(logits),
                                      torch.from_numpy(toks), z))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch)
    jt = jstep.TrainConfig()
    (jtot, (jloss, jaux)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, jcfg, jt, b), has_aux=True))(jp, jb)
    tt = tstep.TrainConfig()
    tot, (loss, aux) = tstep.loss_fn(tp, tcfg, tt, tb)
    names = [k for k, _ in leaves_with_path(tp)]
    gs = torch.autograd.grad(tot, [p for _, p in leaves_with_path(tp)],
                             allow_unused=True)
    assert all(g is not None for g in gs), [n for n, g in zip(names, gs)
                                            if g is None]
    tot, loss = float(tot.detach()), float(loss.detach())
    assert abs(tot - float(jtot)) <= LOSS_TOL * abs(float(jtot))
    assert abs(loss - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    if tcfg.n_experts:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux.detach()), float(jaux),
                                   rtol=1e-4)
    got = {"/".join(str(k) for k in n): g.double().numpy()
           for n, g in zip(names, gs)}
    assert all(np.isfinite(v).all() for v in got.values())
    err = _leaf_err(got, _by_key(jg, True))
    worst = max(err, key=err.get)
    print(f"{arch}: worst leaf {worst} {err[worst]:.3e}")
    assert err[worst] <= GRAD_TOL, (worst, err[worst])
