"""The port's Mamba2 block (``repro_torch.models.mamba``) against the JAX
package's, on the CPU.

Reduced configs, float32, B = 2, the reference's weights: ``ssd_chunked``'s
output and final state within 1e-5 relative (several chunks, a carried
state); ``mamba_train`` at S = 32 and S = 30 (a padded last chunk) and its
cache; ``mamba_decode`` steps after it, within 2e-4 (the model tests'
``TOL``); the causal conv; in bfloat16 the block gives the reference's
bits but for at most 1% of the values (each mutated cast fails that);
ROADMAP C21 (the reference's decay matrix overflows to NaN at a chunk of
256, the port's does not); and ``prune_tree`` on a jamba cache tree passes
its ``MambaCache``s through.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import layer_ctx as jctx
from repro.models import mamba as jmb
from repro_torch.configs import registry as treg
from repro_torch.configs.base import layer_ctx as tctx
from repro_torch.models import attention as tattn
from repro_torch.models import mamba as tmb
from repro_torch.models import model as tm
from repro_torch.models.params import init_params
from repro_torch.serving import kv_prune

B = 2
TOL = 2e-4
ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block(arch, seed=0):
    """(JAX spec, port spec, JAX params, port params) of ``arch``'s first
    Mamba layer at its reduced widths."""
    jcfg, tcfg = jreg.get_reduced(arch), treg.get_reduced(arch)
    j = next(i for i, ls in enumerate(tcfg.pattern) if ls.kind == "mamba")
    jspec, tspec = jctx(jcfg, jcfg.pattern[j]), tctx(tcfg, tcfg.pattern[j])
    # the port's init (crc32 of the path: the same weights in every
    # process; the reference's folds a salted hash), carried to JAX
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), init_params(
        tmb.mamba_defs(tspec), seed, "cpu").tree())
    # the init leaves dt_bias at 0 and A_log at 1: spread them
    rng = np.random.default_rng(seed)
    jp = dict(jp, dt_bias=jnp.asarray(rng.normal(0, 0.5, jspec.m_heads),
                                      jnp.float32),
              A_log=jnp.asarray(rng.normal(0, 0.5, jspec.m_heads),
                                jnp.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jspec, tspec, jp, tp


def _ssd_inputs(seed, T, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.exp(rng.normal(0, 0.5, H)).astype(np.float32)
    Bm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, D, s0


def _rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= rtol * scale, \
        (np.max(np.abs(got - want)), scale)


@pytest.mark.parametrize("carried", (False, True), ids=("s0", "carried"))
@pytest.mark.parametrize("shape", ((64, 8, 16, 2, 8, 16),
                                   (48, 4, 8, 1, 16, 16)),
                         ids=("G2-4chunks", "G1-3chunks"))
def test_ssd_chunked_matches_reference(shape, carried):
    T, H, P, G, N, Q = shape
    x, dt, A, Bm, Cm, D, s0 = _ssd_inputs(1, T, H, P, G, N)
    args = (x, dt, A, Bm, Cm, D)
    jy, js = jmb.ssd_chunked(*map(jnp.asarray, args), Q=Q,
                             s0=jnp.asarray(s0.reshape(
                                 B, G, H // G, P, N)) if carried else None)
    ty, ts = tmb.ssd_chunked(*map(torch.from_numpy, args), Q=Q,
                             s0=torch.from_numpy(s0) if carried else None)
    _rel_close(ty.numpy(), jy, 1e-5)
    _rel_close(ts.numpy(), js, 1e-5)


def test_ssd_decay_matrix_stays_finite_at_long_chunks():
    """ROADMAP C21: at a chunk of 256 with ``dt`` near 1 the reference's
    ``exp(diff) * causal`` overflows above the diagonal and ``inf * 0``
    makes most of its output NaN; the port masks before ``exp`` and equals
    the step-by-step recurrence (``mamba_decode``'s) there."""
    T, H, P, G, N = 256, 4, 8, 1, 8
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(2, T, H, P, G, N)
    A = -np.exp(np.ones(H, np.float32))            # the reference's init
    args = (x, dt, A, Bm, Cm, D)
    jy, _ = jmb.ssd_chunked(*map(jnp.asarray, args), Q=T)
    assert np.mean(np.isnan(np.asarray(jy))) > 0.5
    ty, ts = tmb.ssd_chunked(*map(torch.from_numpy, args), Q=T)
    assert torch.isfinite(ty).all() and torch.isfinite(ts).all()
    s = np.zeros((B, H, P, N), np.float64)
    want = np.zeros((B, T, H, P))
    for t in range(T):
        s = s * np.exp(dt[:, t] * A)[..., None, None] + np.einsum(
            "bn,bhp->bhpn", Bm[:, t, 0], x[:, t] * dt[:, t, :, None])
        want[:, t] = np.einsum("bn,bhpn->bhp", Cm[:, t, 0], s) + \
            D[None, :, None] * x[:, t]
    # float32 log-decays summed over 256 steps reach ~-500, with ~3e-5
    # absolute error: the float64 recurrence agrees to 1e-4 relative
    _rel_close(ty.numpy(), want, 1e-4)
    _rel_close(ts.numpy(), s, 1e-4)


@pytest.mark.parametrize("T", (32, 30))
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_train_and_decode_match_reference(arch, T):
    jspec, tspec, jp, tp = _block(arch)
    x = np.random.default_rng(3).standard_normal(
        (B, T + 3, jspec.d_model)).astype(np.float32)
    jy, jc = jmb.mamba_train(jp, jnp.asarray(x[:, :T]), jspec)
    ty, tc = tmb.mamba_train(tp, torch.from_numpy(x[:, :T]), tspec)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for f in tmb.MambaCache._fields:
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    for i in range(3):
        xi = x[:, T + i:T + i + 1]
        jy, jc = jmb.mamba_decode(jp, jnp.asarray(xi), jc, jspec)
        ty, tc2 = tmb.mamba_decode(tp, torch.from_numpy(xi), tc, tspec)
        assert tc2 is tc                      # updated in place
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tc.ssm.numpy(), np.asarray(jc.ssm),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc.conv_x.numpy(), np.asarray(jc.conv_x),
                                   rtol=TOL, atol=TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 20, 24)).astype(np.float32)
    k = rng.standard_normal((4, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tmb._causal_conv(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
        np.asarray(jmb._causal_conv(jnp.asarray(x), jnp.asarray(k))),
        rtol=1e-6, atol=1e-6)


def _reference_ssd(*args, Q, s0=None):
    """The reference's ``ssd_chunked`` on the port's tensors."""
    y, s = jmb.ssd_chunked(*(jnp.asarray(a.numpy()) for a in args), Q=Q,
                           s0=None if s0 is None else jnp.asarray(s0.numpy()))
    return torch.from_numpy(np.array(y)), torch.from_numpy(np.array(s))


def _bf16_block(train=None, decode=None):
    """(port, reference) bfloat16 outputs of jamba's reduced Mamba block:
    a 32-step train pass and a decode step after it (the port through
    ``train``/``decode``, default ``mamba_train``/``mamba_decode``).  The
    port's train pass runs the reference's float32 SSD, so the casts
    around it are compared alone (``test_ssd_chunked_matches_reference``
    holds the SSD; its summation order moves a bfloat16 rounding in
    0.01-1% of the values, by the weights)."""
    jspec, tspec, jp, _ = _block("jamba-1.5-large-398b", seed=2)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(
        a, np.float32)).bfloat16(), jp)
    x = jnp.asarray(np.random.default_rng(5).standard_normal(
        (B, 33, jspec.d_model)), jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    jy, jc = jmb.mamba_train(jp, x[:, :32], jspec)
    jd, _ = jmb.mamba_decode(jp, x[:, 32:], jc, jspec)
    ssd = tmb.ssd_chunked
    tmb.ssd_chunked = _reference_ssd
    try:
        ty, tc = (train or tmb.mamba_train)(tp, tx[:, :32], tspec)
    finally:
        tmb.ssd_chunked = ssd
    td, _ = (decode or tmb.mamba_decode)(tp, tx[:, 32:], tc, tspec)
    return ((ty, np.asarray(jy.astype(jnp.float32))),
            (td, np.asarray(jd.astype(jnp.float32))))


def bf16_parts(got: torch.Tensor, want: np.ndarray) -> float:
    """The share of bfloat16 values that differ from the reference's."""
    assert got.dtype == torch.bfloat16
    return float(np.mean(got.float().numpy() != want))


def test_bfloat16_mamba_casts_match_reference():
    """In bfloat16 the projections, the conv (float32 sums, one rounding)
    and the gate run in bfloat16, the SSD in float32 cast back before the
    gated norm (float32 statistics), the decode's conv step in float32:
    the reference's bits but for at most 1% of the values (a float32 SSD
    sum's last bits may move a rounding).  A mutated cast parts in more."""
    for got, want in _bf16_block():
        assert bf16_parts(got, want) <= 0.01


def test_prune_tree_passes_mamba_caches_through():
    """jamba's prefill caches: ``prune_tree`` compacts the attention layer's
    ``KVCache`` and returns every stacked ``MambaCache`` as it was; decode
    then runs on the mixed tree."""
    cfg = treg.get_reduced("jamba-1.5-large-398b")
    tp = init_params(tm.model_defs(cfg), 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, 64))).long()
    _, caches = tm.prefill(tp, cfg, {"tokens": toks}, max_len=68)
    kinds = {k: type(c) for k, c in caches["blocks"].items()}
    assert set(kinds.values()) == {tattn.KVCache, tmb.MambaCache}
    before = {k: [t.clone() for t in c] for k, c in caches["blocks"].items()}
    pruned = kv_prune.prune_tree(caches, keep=24, lags=4)
    for k, c in pruned["blocks"].items():
        if kinds[k] is tmb.MambaCache:
            assert type(c) is tmb.MambaCache
            assert all(torch.equal(a, b) for a, b in zip(c, before[k]))
        else:
            assert c.k.shape[2] == 24 and c.pos_ids.shape == (1, B, 24)
    logits, _ = tm.decode_step(tp, cfg, toks[:, :1], pruned, 64)
    assert logits.shape == (B, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
