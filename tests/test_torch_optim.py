"""The port's optimizers, schedules and gradient codecs
(``repro_torch.optim``) against the JAX package's, on the CPU, and the
port's own versions of the reference's ``tests/test_optim.py`` properties.

The same numpy trees (float32 and bfloat16 leaves) go through both.
Tolerances: float32 results within ``F32_TOL`` x the leaf's largest
|value| (the frameworks round ``b ** step``, the means and the
contracted multiply-adds each their own way); the global norm within
``NORM_TOL`` relative (XLA's float32 sum of a 54,600-value leaf is 4e-6
from the exact one, torch's pairwise sum 1e-7); bfloat16 results within
one bfloat16 step of the value (2^-7 relative: a float32 result a
rounding apart may round to the neighbouring bfloat16) or of ``F32_TOL``
x the leaf's largest |value| (a value that cancels to near zero, as
``b1 m + (1 - b1) g`` can, keeps the float32 error of its operands); the
schedules
within 1e-7 relative; topk masks and int8 codes bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jaf
from repro.optim import adamw as jadam
from repro.optim import compress as jcomp
from repro.optim import schedule as jsched
from repro_torch.convert import opt_state_from_numpy
from repro_torch.optim import adafactor as taf
from repro_torch.optim import adamw as tadam
from repro_torch.optim import compress as tcomp
from repro_torch.optim import schedule as tsched
from repro_torch.tree import leaves

F32_TOL = 2e-5
NORM_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _trees(seed, bf16: bool, scale: float = 1.0):
    """(JAX tree, torch tree) of the same parameter-like tree, its values
    normal x ``scale``; with ``bf16`` one leaf is bfloat16."""
    rng = np.random.default_rng(seed)
    t = {"a": rng.standard_normal((8, 160)),
         "b": {"c": rng.standard_normal(5),
               "d": rng.standard_normal((3, 130, 140))}}
    j = jax.tree.map(lambda a: jnp.asarray((a * scale).astype(np.float32)), t)
    if bf16:
        j["b"]["d"] = j["b"]["d"].astype(jnp.bfloat16)
    return j, _port(j)


def _check(got, want, what=""):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape, what
        wf = np.asarray(w.astype(jnp.float32), np.float64)
        gf = g.detach().float().double().numpy()
        floor = F32_TOL * max(float(np.max(np.abs(wf))), 1e-30)
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16, what
            tol = np.maximum(BF16_TOL * np.abs(wf), floor)
            assert np.all(np.abs(gf - wf) <= tol), what
        else:
            assert float(np.max(np.abs(gf - wf))) <= floor, what


def _port(jtree):
    """The port's tree of a JAX tree (bfloat16 kept, exactly)."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32),
        jtree)


@pytest.mark.parametrize("bf16", (False, True))
@pytest.mark.parametrize("state_dtype", (None, "float32"))
@pytest.mark.parametrize("clip", (None, 1.0))
def test_adamw_matches_reference(clip, state_dtype, bf16):
    """Four steps; each from the reference's parameters and state of the
    step before, carried across (``convert.opt_state_from_numpy``), so
    every step is held to one update's roundings."""
    jc = jadam.AdamWConfig(clip_norm=clip, state_dtype=state_dtype)
    tc = tadam.AdamWConfig(clip_norm=clip, state_dtype=state_dtype)
    jp, _ = _trees(0, bf16)
    js = jadam.adamw_init(jp, jc)
    ts0 = tadam.adamw_init(_port(jp), tc)
    assert [t.dtype for t in leaves(ts0.m)] == \
        [torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
         for a in jax.tree.leaves(js.m)]
    upd = jax.jit(lambda g, s, p, lr: jadam.adamw_update(g, s, p, lr, jc))
    for step in range(4):
        jg, tg = _trees(10 + step, bf16, 3.0 if step % 2 else 0.2)
        tp = _port(jp)
        ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
        lr = jsched.warmup_cosine(step, peak_lr=1e-2, warmup=2, total=10)
        jp, js, jn = upd(jg, js, jp, lr)
        tp, ts, tn = tadam.adamw_update(
            tg, ts, tp, tsched.warmup_cosine(step, peak_lr=1e-2, warmup=2,
                                             total=10), tc)
        assert float(tn) == pytest.approx(float(jn), rel=NORM_TOL)
        assert int(ts.step) == int(js.step) == step + 1
        _check(tp, jp, f"params {step}")
        _check(ts.m, js.m, f"m {step}")
        _check(ts.v, js.v, f"v {step}")


@pytest.mark.parametrize("bf16", (False, True))
def test_global_norm_and_clip_match_reference(bf16):
    jg, tg = _trees(3, bf16)
    assert float(tadam.global_norm(tg)) == pytest.approx(
        float(jadam.global_norm(jg)), rel=NORM_TOL)
    for max_norm in (0.5, 1e6):
        jc, jn = jadam.clip_by_global_norm(jg, max_norm)
        tc, tn = tadam.clip_by_global_norm(tg, max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=NORM_TOL)
        assert all(t.dtype == torch.float32 for t in leaves(tc))
        _check(tc, jc, f"clip {max_norm}")


@pytest.mark.parametrize("min_dim", (128, 4096))
def test_adafactor_matches_reference(min_dim):
    """Factored (``min_dim`` 128: ``a`` and ``d`` factored, ``c``
    unfactored) and all unfactored (4096), five steps, each from the
    reference's parameters and state of the step before."""
    jc = jaf.AdafactorConfig(min_dim_factored=min_dim)
    tc = taf.AdafactorConfig(min_dim_factored=min_dim)
    jp, tp = _trees(1, True)
    js, ts = jaf.adafactor_init(jp, jc), taf.adafactor_init(tp, tc)
    assert [tuple(v.shape) for v in leaves(ts.vr)] == \
        [v.shape for v in jax.tree.leaves(js.vr)]
    assert [tuple(v.shape) for v in leaves(ts.vc)] == \
        [v.shape for v in jax.tree.leaves(js.vc)]
    upd = jax.jit(lambda g, s, p, lr: jaf.adafactor_update(g, s, p, lr, jc))
    for step in range(5):
        jg, tg = _trees(20 + step, True)
        tp = _port(jp)
        ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
        jp, js = upd(jg, js, jp, jnp.float32(0.01))
        tp, ts = taf.adafactor_update(tg, ts, tp, 0.01, tc)
        assert int(ts.step) == int(js.step) == step + 1
        _check(tp, jp, f"params {step}")
        _check(ts.vr, js.vr, f"vr {step}")
        _check(ts.vc, js.vc, f"vc {step}")


@pytest.mark.parametrize("name", ("warmup_cosine", "constant",
                                  "warmup_linear"))
def test_schedules_match_reference(name):
    kw = dict(peak_lr=3e-4, warmup=7, total=40)
    for step in range(0, 46):
        want = float(jsched.SCHEDULES[name](step, **kw))
        got = tsched.SCHEDULES[name](step, **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-7, abs=1e-12), step
        tstep = tsched.SCHEDULES[name](torch.tensor(step), **kw)
        assert float(tstep) == float(got)


@pytest.mark.parametrize("codec,ratio", (("topk", 0.05), ("topk", 0.3),
                                         ("int8", 0.05), ("none", 0.05)))
def test_compress_matches_reference(codec, ratio):
    rng = np.random.default_rng(5)
    g = rng.standard_normal((40, 33)).astype(np.float32)
    g[3, :10] = 0.75                      # ties at and around a threshold
    g[7, 5] = -g.max() - 1.0
    jcfg = jcomp.CompressConfig(codec=codec, ratio=ratio)
    tcfg = tcomp.CompressConfig(codec=codec, ratio=ratio)
    if codec == "topk":
        np.testing.assert_array_equal(
            tcomp.topk_mask(torch.from_numpy(g), ratio).numpy(),
            np.asarray(jcomp.topk_mask(jnp.asarray(g), ratio)))
    js, jr = jcomp.compress(jnp.asarray(g), jcfg)
    ts, tr = tcomp.compress(torch.from_numpy(g), tcfg)
    if codec == "int8":
        scale = float(np.max(np.abs(g))) / 127.0
        np.testing.assert_array_equal(np.round(ts.numpy() / scale),
                                      np.round(np.asarray(js) / scale))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-7)
    # with error feedback over a tree, three rounds
    jtree = {"w": jnp.asarray(g), "v": {"u": jnp.asarray(g[:5])}}
    ttree = {"w": torch.from_numpy(g), "v": {"u": torch.from_numpy(g[:5])}}
    jres, tres = jcomp.init_residuals(jtree), tcomp.init_residuals(ttree)
    for _ in range(3):
        jsent, jres = jcomp.compress_with_feedback(jtree, jres, jcfg)
        tsent, tres = tcomp.compress_with_feedback(ttree, tres, tcfg)
        for a, b in zip(leaves(tsent) + leaves(tres),
                        jax.tree.leaves(jsent) + jax.tree.leaves(jres)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the reference's tests/test_optim.py properties, on the port
# ---------------------------------------------------------------------------

def test_adamw_matches_hand_math():
    cfg = tadam.AdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                            clip_norm=None)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    state = tadam.adamw_init(p, cfg)
    p2, _, _ = tadam.adamw_update(g, state, p, 0.01, cfg)
    gw = g["w"].numpy()
    m, v = 0.1 * gw, 0.001 * gw ** 2
    want = np.array([1.0, -2.0, 3.0]) - 0.01 * (m / 0.1) / (
        np.sqrt(v / 0.001) + 1e-8)
    np.testing.assert_allclose(p2["w"].numpy(), want, rtol=1e-6)


def test_adamw_converges_on_quadratic():
    cfg = tadam.AdamWConfig(weight_decay=0.0)
    p = {"w": torch.from_numpy(np.linspace(-2, 2, 8))}
    state = tadam.adamw_init(p, cfg)
    for _ in range(300):
        g = {"w": 2 * (p["w"] - 1.0)}
        p, state, _ = tadam.adamw_update(g, state, p, 0.05, cfg)
    assert float(torch.max(torch.abs(p["w"] - 1.0))) < 0.05


def test_adafactor_converges_and_state_is_factored():
    cfg = taf.AdafactorConfig(min_dim_factored=4)
    p = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(8, 8)))}
    state = taf.adafactor_init(p, cfg)
    assert state.vr["w"].shape == (8,) and state.vc["w"].shape == (8,)
    loss0 = float(torch.sum((p["w"] - 1) ** 2))
    for _ in range(200):
        g = {"w": 2 * (p["w"] - 1)}
        p, state = taf.adafactor_update(g, state, p, 0.05, cfg)
    assert float(torch.sum((p["w"] - 1) ** 2)) < 0.2 * loss0


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, norm = tadam.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    assert abs(float(tadam.global_norm(clipped)) - 1.0) < 1e-6


def test_schedules():
    assert abs(float(tsched.warmup_cosine(0, peak_lr=1.0, warmup=10,
                                          total=100)) - 0.1) < 1e-6
    assert abs(float(tsched.warmup_cosine(10, peak_lr=1.0, warmup=10,
                                          total=100)) - 1.0) < 1e-6
    assert float(tsched.warmup_cosine(100, peak_lr=1.0, warmup=10,
                                      total=100)) < 0.11
    assert float(tsched.warmup_linear(100, peak_lr=1.0, warmup=10,
                                      total=100)) < 1e-6


def test_gradient_compression_error_feedback_convergence():
    """SGD with top-k compression and error feedback converges."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(16, 16)))
    b = torch.from_numpy(rng.normal(size=(16,)))

    def loss(w):
        return torch.sum((A @ w - b) ** 2)

    def grad(w):
        return 2 * A.T @ (A @ w - b)

    ccfg = tcomp.CompressConfig(codec="topk", ratio=0.2)
    w = torch.zeros(16, dtype=torch.float64)
    res = tcomp.init_residuals({"w": w})
    for _ in range(2000):
        sent, res = tcomp.compress_with_feedback({"w": grad(w)}, res, ccfg)
        w = w - 0.01 * sent["w"].double()
    assert float(loss(w)) < 0.15 * float(loss(torch.zeros(16,
                                                          dtype=torch.float64)))


def test_int8_compression_roundtrip_accuracy():
    ccfg = tcomp.CompressConfig(codec="int8")
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(64,)))}
    sent, _ = tcomp.compress_with_feedback(g, tcomp.init_residuals(g), ccfg)
    rel = float(torch.linalg.norm(sent["w"] - g["w"].float())
                / torch.linalg.norm(g["w"]))
    assert rel < 0.02
