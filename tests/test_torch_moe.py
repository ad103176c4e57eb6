"""The port's MoE layer (``repro_torch.models.moe``, ``moe_a2a``) against the
JAX package's, on the CPU.

Reduced configs, float32, B = 2, S = 32, the reference's weights carried by
``convert.params_from_numpy``: the routes, positions and keep masks of
``moe_apply`` equal the reference's, its output and aux loss within 2e-4
(the model tests' ``TOL``), with and without capacity drops and with a
shared expert; the router's top-k breaks ties as ``lax.top_k`` does; the
a2a helpers equal theirs; in bfloat16 the layer gives the reference's bits
(each mutated cast fails that).  The a2a forms run on four gloo ranks
(data 2 x model 2) in one spawn: ``a2a`` and ``a2a2d`` within 1e-3 x RMS
of the scatter path, ``a2a_q8``'s mean within 0.02 (the reference's own
bounds, ``tests/test_dryrun_small.py:243-252``), and ``a2a_q8`` against
the reference's own on a 4-device host mesh (a JAX subprocess).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import registry as jreg
from repro.configs.base import layer_ctx as jctx
from repro.models import moe as jmoe
from repro.models import moe_a2a as ja2a
from repro_torch import sharding as shd
from repro_torch.baselines.line_simpl import top_k_total
from repro_torch.configs import registry as treg
from repro_torch.configs.base import layer_ctx as tctx
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_a2a as ta2a
from repro_torch.models.params import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 32
TOL = 2e-4
MOE_ARCHS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b")
# the a2a cells: the reduced qwen3-moe at capacity factor 8 (no drops),
# 4 rows of 32 tokens (and 31, where the sequence does not split over the
# model axis), on a (data 2, model 2) mesh
A2A_ARCH = "qwen3-moe-235b-a22b"
A2A_B = 4
A2A_IMPLS = ("scatter", "a2a", "a2a_q8", "a2a2d")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer(arch, cf=None, n_shared=0, seed=0):
    """(JAX spec, port spec, JAX params, port params) of ``arch``'s first
    MoE layer at its reduced widths (capacity factor ``cf``)."""
    jcfg, tcfg = jreg.get_reduced(arch), treg.get_reduced(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    j = next(i for i, ls in enumerate(tcfg.pattern) if ls.moe)
    defs = tmoe.moe_defs(tcfg.d_model, tcfg.d_ff_expert, tcfg.n_experts,
                         n_shared)
    # the port's init (crc32 of the path: the same weights in every
    # process; the reference's folds a salted hash), carried to JAX
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                      init_params(defs, seed, "cpu").tree())
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return (jctx(jcfg, jcfg.pattern[j]), tctx(tcfg, tcfg.pattern[j]), jp,
            tp)


def _x(d, seed=0, skew=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    x[..., :4] += skew          # pulls the router towards a few experts
    return x


def _routes(jp, x, k, E):
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jnp.float32),
                        jp["router"].astype(jnp.float32))
    w, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    return np.asarray(eidx), np.asarray(jmoe._positions_in_expert(eidx, E))


@pytest.mark.parametrize("cf", (1.25, 0.5), ids=("cf1.25", "drops"))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    jspec, tspec, jp, tp = _layer(arch, cf)
    x = _x(jspec.d_model, skew=2.0 if cf < 1 else 0.0)
    eidx, pos = _routes(jp, x, jspec.top_k, jspec.n_experts)
    _, _, _, te = tmoe.route(tp, torch.from_numpy(x), tspec.top_k)
    tpos = tmoe._positions_in_expert(te, tspec.n_experts)
    np.testing.assert_array_equal(te.numpy(), eidx)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    C = tmoe.capacity(S, tspec.top_k, tspec.n_experts, cf)
    assert C == int(max(np.ceil(S * jspec.top_k / jspec.n_experts * cf / 8)
                        * 8, 8))
    if cf < 1:
        assert np.any(pos >= C), "the drop case must drop assignments"
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jspec)
    got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tspec)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)


def test_shared_expert_matches_reference():
    jspec, tspec, jp, tp = _layer(A2A_ARCH, n_shared=1, seed=3)
    assert "shared" in tp
    x = _x(jspec.d_model, seed=4)
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x), jspec)
    got, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_router_top_k_breaks_ties_as_lax_top_k():
    """Equal probabilities go to the lower expert first, as ``lax.top_k``
    ranks them; ``torch.topk`` does not promise that order."""
    rng = np.random.default_rng(5)
    v = rng.choice(np.float32([0.1, 0.2, 0.3, 0.05]), (6, 9, 16))
    w, idx = top_k_total(torch.from_numpy(v), 4)
    jw, jidx = jax.lax.top_k(jnp.asarray(v), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_a2a_helpers_match_reference():
    rng = np.random.default_rng(6)
    dest = rng.integers(0, 5, 300).astype(np.int32)
    np.testing.assert_array_equal(
        ta2a._positions_by_dest(torch.from_numpy(dest), 5).numpy(),
        np.asarray(ja2a._positions_by_dest(jnp.asarray(dest), 5, 8)))
    t = (rng.standard_normal((3, 7, 256)) *
         np.exp2(rng.integers(-6, 6, (3, 7, 1)))).astype(np.float32)
    q, s = ta2a._q8(torch.from_numpy(t))
    jq, js = ja2a._q8(jnp.asarray(t))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        ta2a._dq8(q, s, torch.float32).numpy(),
        np.asarray(ja2a._dq8(jq, js, jnp.float32)))


def test_dispatcher_falls_back_to_scatter():
    """No mesh, a model axis of one rank, or experts that do not divide
    over it: the scatter path, as the reference's dispatcher."""
    _, tspec, _, tp = _layer(A2A_ARCH)
    x = torch.from_numpy(_x(tspec.d_model))
    want = tmoe.moe_apply(tp, x, tspec)[0]
    assert shd.active_mesh() is None
    for impl in A2A_IMPLS:
        assert torch.equal(ta2a.moe_apply(tp, x, tspec, impl)[0], want)

    class _Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, mp):
            self.mp = mp

        def size(self, i):
            return (2, self.mp)[i]

    for mesh, spec in ((_Mesh(1), tspec),
                       (_Mesh(3), tspec)):     # 8 experts over 3 ranks
        with shd.use_sharding(mesh):
            assert shd.active_mesh() is mesh
            assert torch.equal(ta2a.moe_apply(tp, x, spec, "a2a")[0], want)
    assert shd.active_mesh() is None


# ---------------------------------------------------------------------------
# bfloat16 casts
# ---------------------------------------------------------------------------

def _bf16_moe(layer_fn=None):
    """(port, reference) outputs of a reduced MoE layer on bfloat16 inputs
    and weights (the port through ``layer_fn``, default ``moe_apply``)."""
    jspec, tspec, jp, _ = _layer(A2A_ARCH, seed=1)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(
        a, np.float32)).bfloat16(), jp)
    x = jnp.asarray(_x(jspec.d_model, seed=2), jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got, aux = (layer_fn or tmoe.moe_apply)(tp, tx, tspec)
    want, jaux = jmoe.moe_apply(jp, x, jspec)
    return got, aux, np.asarray(want.astype(jnp.float32)), float(jaux)


def bf16_parts(got: torch.Tensor, want: np.ndarray) -> float:
    """The share of bfloat16 values that differ from the reference's."""
    assert got.dtype == torch.bfloat16
    return float(np.mean(got.float().numpy() != want))


def test_bfloat16_moe_casts_match_reference():
    """In bfloat16 the router runs in float32, the buffer, the expert
    products and the combine weights in bfloat16, and SiLU rounds as
    ``jax.nn.silu`` (``x * (1 / (1 + exp(-x)))``, a rounding a step): the
    reference's bits, but for at most 1% of the values (a float32 sum's
    last bit may move a rounding).  A mutated cast parts in ~30-70%."""
    got, aux, want, jaux = _bf16_moe()
    assert bf16_parts(got, want) <= 0.01
    assert aux.dtype == torch.float32
    assert abs(float(aux) - jaux) <= 1e-6 * abs(jaux)


# ---------------------------------------------------------------------------
# the a2a forms on four gloo ranks
# ---------------------------------------------------------------------------

def _a2a_cfg(impl="scatter"):
    return dataclasses.replace(treg.get_reduced(A2A_ARCH), capacity_factor=8.0,
                               moe_impl=impl)


def _a2a_tokens(S_):
    return np.random.default_rng(7).integers(
        0, _a2a_cfg().vocab, (A2A_B, S_)).astype(np.int64)


def _a2a_rank(rank, world, rdv, out_dir):
    """One gloo rank of the (data 2, model 2) mesh: ``forward`` under every
    impl at S = 32, and ``a2a`` at S = 31."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        mesh = shd.mesh_2d(2, 2, "cpu")
        params = init_params(tm.model_defs(_a2a_cfg()), 0, "cpu")
        out = {}
        with shd.use_sharding(mesh):
            for impl in A2A_IMPLS:
                logits, aux = tm.forward(params, _a2a_cfg(impl), {
                    "tokens": torch.from_numpy(_a2a_tokens(32))})
                out[impl] = (logits, aux)
            out["a2a_s31"] = tm.forward(params, _a2a_cfg("a2a"), {
                "tokens": torch.from_numpy(_a2a_tokens(31))})
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


_JAX_Q8 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np, torch
sys.path.insert(0, {tests!r})
import test_torch_moe as t
from repro import sharding as shd
from repro.configs.registry import get_reduced
from repro.models.model import forward
from repro.models import model as tm_ref
from repro_torch.models.model import model_defs
from repro_torch.models.params import init_params
tcfg = t._a2a_cfg()
p = init_params(model_defs(tcfg), 0, "cpu").tree()
jp = jax.tree.map(lambda a: jnp.asarray(a.numpy()), p)
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
cfg = dataclasses.replace(get_reduced(t.A2A_ARCH), capacity_factor=8.0)
out = {{}}
with shd.use_sharding(mesh, shd.default_rules()):
    for impl in ("scatter", "a2a_q8"):
        ci = dataclasses.replace(cfg, moe_impl=impl)
        l, a = jax.jit(lambda q, b: forward(q, ci, b))(
            jp, {{"tokens": jnp.asarray(t._a2a_tokens(32), jnp.int32)}})
        out[impl] = np.asarray(l)
np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def a2a_ranks(tmp_path_factory):
    """The four gloo ranks and the reference's a2a_q8 subprocess, started
    together when first asked for."""
    out = tmp_path_factory.mktemp("gloo_moe")
    ref = str(out / "jax_q8.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_Q8.format(
            tests=os.path.dirname(os.path.abspath(__file__)), out=ref)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ctx = mp.spawn(_a2a_rank, args=(4, str(out / "rdv"), str(out)), nprocs=4,
                   join=False)
    cache = {}

    def get():
        if not cache:
            while not ctx.join(timeout=600):
                pass
            cache["ranks"] = [torch.load(out / f"rank{r}.pt")
                              for r in range(4)]
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log
            with np.load(ref) as z:
                cache["jax"] = {k: z[k] for k in z.files}
        return cache

    yield get
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _rel(a, base):
    rms = float(torch.sqrt(torch.mean(base.double() ** 2)))
    d = torch.abs(a.double() - base.double())
    return float(d.max()) / rms, float(d.mean()) / rms


def test_a2a_forms_agree_with_scatter_on_gloo_ranks(a2a_ranks):
    ranks = a2a_ranks()["ranks"]
    base, aux0 = ranks[0]["scatter"]
    for r in ranks:
        # every rank holds the global result, the same bits
        for key in (*A2A_IMPLS, "a2a_s31"):
            assert torch.equal(r[key][0], ranks[0][key][0]), key
            assert torch.equal(r[key][1], ranks[0][key][1]), key
    assert _rel(ranks[0]["a2a"][0], base)[0] < 1e-3
    assert _rel(ranks[0]["a2a2d"][0], base)[0] < 1e-3
    assert _rel(ranks[0]["a2a_q8"][0], base)[1] < 0.02
    # the a2a aux loss averages the blocks' estimates; a2a2d's is 0
    assert float(ranks[0]["a2a2d"][1]) == 0.0
    assert abs(float(ranks[0]["a2a"][1]) - float(aux0)) < 0.05 * float(aux0)
    params = init_params(tm.model_defs(_a2a_cfg()), 0, "cpu")
    one, _ = tm.forward(params, _a2a_cfg(), {
        "tokens": torch.from_numpy(_a2a_tokens(31))})
    assert _rel(ranks[0]["a2a_s31"][0], one)[0] < 1e-3


def test_a2a_q8_matches_reference_on_host_mesh(a2a_ranks):
    """The port's int8 dispatch against the reference's on the same
    weights and tokens (a 4-device host mesh, data 2 x model 2)."""
    got = a2a_ranks()
    port = got["ranks"][0]["a2a_q8"][0]
    ref = torch.from_numpy(got["jax"]["a2a_q8"])
    np.testing.assert_allclose(got["ranks"][0]["scatter"][0].numpy(),
                               got["jax"]["scatter"], rtol=TOL, atol=TOL)
    mx, mean = _rel(port, ref)
    print(json.dumps({"a2a_q8_vs_reference": {"max": mx, "mean": mean}}))
    assert mx < 1e-3
