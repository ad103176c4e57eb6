"""The port's model substrate (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package's, on the CPU.

All ten architectures' reduced configs (float32, B = 2, S = 32; the MoE
and Mamba families' layers are held one by one in ``test_torch_moe.py`` and
``test_torch_mamba.py``), the reference's weights carried across with
``convert.params_from_numpy``: ``forward`` logits and aux loss,
``prefill`` and ``decode_step`` within 2e-4 (the reference's own
``test_prefill_decode_matches_forward`` tolerance; decode against forward
at capacity factor 8 for the MoE archs, as the reference sets it), the
chunked attention path, the int8 cache, gemma3's ring cache past its
window, ``kv_prune = 4`` ring placement, full-size parameter counts, the
loader's checks, one bfloat16 case and the bfloat16 layer casts.  The JAX
side runs under ``jax_enable_x64`` (``tests/conftest.py``), where its
attention scale is a float64 scalar and lifts the scores to float64; the
port's are float32, inside the stated tolerances.
"""
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
from repro.data.pipeline import token_batch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jm
from repro.models.params import init_params as jinit
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tm
from repro_torch.models.params import init_params, path_seed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_ARCHS = ("stablelm-12b", "gemma3-27b", "qwen3-0.6b", "smollm-135m",
              "qwen2-vl-2b", "musicgen-large")
OTHER_ARCHS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "mamba2-2.7b",
               "jamba-1.5-large-398b")
ALL_ARCHS = ATTN_ARCHS + OTHER_ARCHS
B, S = 2, 32
TOL = 2e-4            # the reference's prefill/decode-vs-forward tolerance


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch, seed=0, step=0, **over):
    """(JAX config, port config, JAX params, port params, JAX batch, port
    batch) of ``arch``'s reduced config with ``over`` replaced in both."""
    jcfg = dataclasses.replace(jreg.get_reduced(arch), **over)
    tcfg = dataclasses.replace(treg.get_reduced(arch), **over)
    jp = jinit(jm.model_defs(jcfg), jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jb = token_batch(jcfg, B, S, step=step)
    return jcfg, tcfg, jp, tp, jb, _tbatch(jb)


def _tbatch(jb):
    out = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in jb.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _j_prefill(jp, jcfg, jb, max_len):
    return jax.jit(lambda p, b: jm.prefill(p, jcfg, b, max_len=max_len))(
        jp, jb)


_DECODERS = {}


def _j_decode(jp, jcfg, tok, caches, pos):
    """JAX's decode step, jitted once per config (pos traced)."""
    if jcfg not in _DECODERS:
        _DECODERS[jcfg] = jax.jit(
            lambda p, t, c, q: jm.decode_step(p, jcfg, t, c, q))
    return _DECODERS[jcfg](jp, tok, caches, jnp.asarray(pos, jnp.int32))


def _j_forward(jp, jcfg, jb):
    """JAX's forward logits; a chunked config is traced with x64 off: under
    ``jax_enable_x64`` the reference's float64 attention scale lifts the
    online-softmax carry to float64 and ``lax.scan`` refuses it (ROADMAP
    C17)."""
    fn = jax.jit(lambda p, b: jm.forward(p, jcfg, b))
    if jcfg.attn_chunk is None:
        return fn(jp, jb)[0]
    with jax.enable_x64(False):
        return fn(jp, jb)[0]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch)
    want, jaux = jax.jit(lambda p, b: jm.forward(p, jcfg, b))(jp, jb)
    got, aux = tm.forward(tp, tcfg, tb)
    assert got.shape == (B, S, tcfg.vocab) and got.dtype == torch.float32
    _close(got, want)
    assert aux.dtype == torch.float32
    if tcfg.n_experts:
        # the summed switch and z losses of every MoE layer
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)
    else:
        assert float(aux) == float(jaux) == 0.0


def _moe_over(arch) -> dict:
    """Capacity factor 8 for an MoE arch (no capacity drops), where its
    decode is held to its forward, as the reference's own test sets it."""
    return dict(capacity_factor=8.0) if treg.get_reduced(arch).n_experts \
        else {}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode_match_reference_and_forward(arch):
    """Prefill's logits and caches (every layer's, attention and Mamba),
    then two decode steps, against JAX's; the decode at position S against
    the port's own forward over S + 1 tokens (the reference's
    cache-consistency invariant)."""
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, seed=1, step=1,
                                        **_moe_over(arch))
    full = token_batch(jcfg, B, S + 2, step=7)
    nxt = np.asarray(full["tokens"][:, -2:])
    jl, jc = _j_prefill(jp, jcfg, jb, S + 4)
    tl, tc = tm.prefill(tp, tcfg, tb, max_len=S + 4)
    _close(tl, jl)
    for key, tk in tc["blocks"].items():
        jk = jc["blocks"][key]
        assert type(tk).__name__ == type(jk).__name__
        for f in tk._fields:
            assert getattr(tk, f).shape == getattr(jk, f).shape, (key, f)
            if f == "pos_ids":
                np.testing.assert_array_equal(getattr(tk, f).numpy(),
                                              np.asarray(getattr(jk, f)))
            else:
                _close(getattr(tk, f), getattr(jk, f))
    for i in range(2):
        tok = nxt[:, i:i + 1]
        jl, jc = _j_decode(jp, jcfg, jnp.asarray(tok), jc, S + i)
        tl, tc = tm.decode_step(tp, tcfg, torch.tensor(tok).long(), tc,
                                S + i)
        assert tl.shape == (B, 1, tcfg.vocab)
        _close(tl, jl)
        if i == 0:
            seq = dict(tb, tokens=torch.cat(
                [tb["tokens"], torch.tensor(tok).long()], dim=1))
            fl, _ = tm.forward(tp, tcfg, seq)
            _close(tl[:, 0], fl[:, -1])


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_chunked_attention_matches_unchunked_and_reference(arch):
    """``_sdpa_chunked`` runs only when S > attn_chunk: forced with
    attn_chunk 16 at S = 32, against the port's unchunked path (same math,
    another summation) and JAX's chunked path."""
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, attn_chunk=16)
    got, _ = tm.forward(tp, tcfg, tb)
    plain, _ = tm.forward(tp, dataclasses.replace(tcfg, attn_chunk=None), tb)
    _close(got, plain, 2e-5)
    _close(got, _j_forward(jp, jcfg, jb))


def test_reference_chunked_attention_refuses_x64():
    """ROADMAP C17: the reference's ``_sdpa_chunked`` does not trace under
    ``jax_enable_x64`` (its ``1 / np.sqrt(dh)`` scale is a float64 scalar,
    which lifts the scan's carry); the port's scale is a Python float, and
    the tests trace the reference's chunked path with x64 off."""
    jcfg, tcfg, jp, tp, jb, tb = _setup("qwen3-0.6b", attn_chunk=16)
    assert jax.config.jax_enable_x64
    with pytest.raises(TypeError, match="carry"):
        jax.jit(lambda p, b: jm.forward(p, jcfg, b))(jp, jb)
    got, _ = tm.forward(tp, tcfg, tb)
    _close(got, _j_forward(jp, jcfg, jb))


def test_chunked_wholly_masked_kv_chunk_stays_finite(monkeypatch):
    """``NEG_INF = -1e30`` is finite on purpose (``attention.py:21``): with
    gemma3's window 8 and chunks of 8, a late q chunk meets kv chunks that
    its window masks wholly, first in its walk; exp(s - m) = 1 there until
    a real score arrives, then corr = exp(-1e30 - m) zeroes it.  With -inf
    the same walk gives NaNs."""
    arch = "gemma3-27b"
    over = dict(attn_chunk=8, pattern=(dataclasses.replace(
        treg.get_reduced(arch).pattern[0], window=8),) * 5
        + (treg.get_reduced(arch).pattern[5],))
    jover = dict(over, pattern=(dataclasses.replace(
        jreg.get_reduced(arch).pattern[0], window=8),) * 5
        + (jreg.get_reduced(arch).pattern[5],))
    jcfg = dataclasses.replace(jreg.get_reduced(arch), **jover)
    tcfg = dataclasses.replace(treg.get_reduced(arch), **over)
    jp = jinit(jm.model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jb = token_batch(jcfg, B, S, step=0)
    tb = _tbatch(jb)
    got, _ = tm.forward(tp, tcfg, tb)
    assert torch.isfinite(got).all()
    plain, _ = tm.forward(tp, dataclasses.replace(tcfg, attn_chunk=None), tb)
    _close(got, plain, 2e-5)
    _close(got, _j_forward(jp, jcfg, jb))
    monkeypatch.setattr(tattn, "NEG_INF", float("-inf"))
    bad, _ = tm.forward(tp, tcfg, tb)
    assert torch.isnan(bad).any()


def test_int8_cache_close_to_float_and_reference():
    """The int8 cache at the reference test's 0.05 x RMS with equal top-1
    tokens, and against JAX's int8 decode (the rotated keys differ in the
    last bits, so a value may quantize one step apart)."""
    jcfg, tcfg, jp, tp, jb, tb = _setup("qwen3-0.6b")
    tok = tb["tokens"][:, -1:]

    def run(c):
        _, caches = tm.prefill(tp, c, tb, max_len=S + 4)
        return tm.decode_step(tp, c, tok, caches, S)[0]

    lf = run(tcfg)
    q8 = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    lq = run(q8)
    rms = float(torch.sqrt(torch.mean(lf * lf)))
    assert float(torch.max(torch.abs(lf - lq))) / rms < 0.05
    assert torch.equal(torch.argmax(lf[:, 0], -1), torch.argmax(lq[:, 0], -1))
    jq8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    _, jc = _j_prefill(jp, jq8, jb, S + 4)
    jl, _ = _j_decode(jp, jq8, jb["tokens"][:, -1:], jc, S)
    assert float(np.max(np.abs(lq.numpy() - np.asarray(jl)))) / rms < 1e-3


def test_quantize_kv_matches_reference():
    x = np.random.default_rng(3).standard_normal((2, 5, 3, 16)).astype(
        np.float32) * 4
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    tq, ts = tattn._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattn._dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jattn._dequantize_kv(jq, js, jnp.float32)))


def test_gemma3_ring_cache_past_window():
    """gemma3's local layers (window 16) keep a ring of 16: 20 decode steps
    write past it; each step's logits against JAX's and the port's
    forward over the same tokens."""
    jcfg, tcfg, jp, tp, jb, tb = _setup("gemma3-27b", seed=2)
    steps = 20
    extra = np.asarray(token_batch(jcfg, B, steps, step=5)["tokens"])
    _, jc = _j_prefill(jp, jcfg, jb, S + steps)
    _, tc = tm.prefill(tp, tcfg, tb, max_len=S + steps)
    assert tc["blocks"]["sub0"].k.shape[2] == 16            # the ring
    assert tc["blocks"]["sub5"].k.shape[2] == S + steps     # global layer
    seq = torch.cat([tb["tokens"], torch.tensor(extra).long()], dim=1)
    fl, _ = tm.forward(tp, tcfg, dict(tokens=seq))
    for i in range(steps):
        tok = extra[:, i:i + 1]
        jl, jc = _j_decode(jp, jcfg, jnp.asarray(tok), jc, S + i)
        tl, tc = tm.decode_step(tp, tcfg, torch.tensor(tok).long(), tc,
                                S + i)
        _close(tl, jl)
        _close(tl[:, 0], fl[:, S + i])
    np.testing.assert_array_equal(tc["blocks"]["sub0"].pos_ids.numpy(),
                                  np.asarray(jc["blocks"]["sub0"].pos_ids))


def test_kv_prune_config_ring_placement():
    """``cfg.kv_prune = 4``: a cache of (S + 4) // 4 = 9 slots holds the last
    9 prefill tokens ring-placed (``model.py:116-146``); pos_ids equal JAX's,
    the keys and the next decode within 2e-4."""
    jcfg, tcfg, jp, tp, jb, tb = _setup("qwen3-0.6b", kv_prune=4)
    _, jc = _j_prefill(jp, jcfg, jb, S + 4)
    _, tc = tm.prefill(tp, tcfg, tb, max_len=S + 4)
    jk, tk = jc["blocks"]["sub0"], tc["blocks"]["sub0"]
    assert tk.k.shape[2] == 9
    np.testing.assert_array_equal(tk.pos_ids.numpy(), np.asarray(jk.pos_ids))
    assert sorted(tk.pos_ids[0, 0].tolist()) == list(range(S - 9, S))
    _close(tk.k, jk.k)
    _close(tk.v, jk.v)
    tok = np.asarray(jb["tokens"][:, :1])
    jl, _ = _j_decode(jp, jcfg, jnp.asarray(tok), jc, S)
    tl, _ = tm.decode_step(tp, tcfg, torch.tensor(tok).long(), tc, S)
    _close(tl, jl)


def test_mrope_position_streams():
    """qwen2-vl's M-RoPE with three distinct position streams [3, B, S] and
    its patch-embedding prefix."""
    jcfg, tcfg, jp, tp, jb, tb = _setup("qwen2-vl-2b")
    rng = np.random.default_rng(4)
    pos3 = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                     rng.integers(0, 8, (B, S)), rng.integers(0, 8, (B, S))]
                    ).astype(np.int32)
    jb = dict(jb, positions=jnp.asarray(pos3))
    tb = dict(tb, positions=torch.from_numpy(pos3))
    want, _ = jax.jit(lambda p, b: jm.forward(p, jcfg, b))(jp, jb)
    got, _ = tm.forward(tp, tcfg, tb)
    _close(got, want)


def test_bfloat16_forward_and_decode():
    """qwen3-0.6b reduced in bfloat16 parameters and activations: logits
    within 3e-2 x RMS (bfloat16 rounds every projection to 8 bits; XLA and
    torch round the products' sums differently) and equal top-1 tokens
    where the reference's top-2 margin exceeds that tolerance."""
    over = dict(param_dtype="bfloat16", activ_dtype="bfloat16")
    jcfg = dataclasses.replace(jreg.get_reduced("qwen3-0.6b"), **over)
    tcfg = dataclasses.replace(treg.get_reduced("qwen3-0.6b"), **over)
    jp = jinit(jm.model_defs(jcfg), jax.random.PRNGKey(0),
               param_dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert tp.tree()["blocks"]["sub0"]["attn"]["q"].dtype == torch.bfloat16
    jb = token_batch(jcfg, B, S, step=0)
    tb = _tbatch(jb)
    want = np.asarray(jax.jit(lambda p, b: jm.forward(p, jcfg, b))(jp, jb)[0])
    got = tm.forward(tp, tcfg, tb)[0].numpy()
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    tol = 3e-2 * rms
    assert float(np.max(np.abs(got - want))) <= tol
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert np.array_equal(np.argmax(got, -1)[sure], np.argmax(want, -1)[sure])
    _, jc = _j_prefill(jp, jcfg, jb, S + 4)
    _, tc = tm.prefill(tp, tcfg, tb, max_len=S + 4)
    assert tc["blocks"]["sub0"].k.dtype == torch.bfloat16
    tok = np.asarray(jb["tokens"][:, :1])
    jl, _ = _j_decode(jp, jcfg, jnp.asarray(tok), jc, S)
    tl, _ = tm.decode_step(tp, tcfg, torch.tensor(tok).long(), tc, S)
    assert float(np.max(np.abs(tl.numpy() - np.asarray(jl)))) <= tol


def _bf16_case(layer, rng):
    """(port output, reference output) of ``layer`` on bfloat16 inputs."""
    def both(a):
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()
    x, tx = both(rng.standard_normal((2, 16, 4, 64)) * 3)
    pos = (np.arange(16)[None] * 37 + np.arange(2)[:, None]).astype(np.int32)
    if layer == "rmsnorm":
        sc, tsc = both(1 + 0.1 * rng.standard_normal(64))
        return (tlayers.rmsnorm({"scale": tsc}, tx),
                jlayers.rmsnorm({"scale": sc}, x))
    if layer == "rope":
        return (tlayers.apply_rope(tx, torch.from_numpy(pos)),
                jlayers.apply_rope(x, jnp.asarray(pos)))
    if layer == "mrope":
        pos3 = np.stack([pos, pos // 3, pos % 5]).astype(np.int32)
        return (tlayers.apply_mrope(tx, torch.from_numpy(pos3),
                                    (16, 8, 8)),
                jlayers.apply_mrope(x, jnp.asarray(pos3), (16, 8, 8)))
    if layer == "embed":
        tab, ttab = both(rng.standard_normal((50, 64)))
        tok = rng.integers(0, 50, (2, 16))
        return (tlayers.embed({"table": ttab}, torch.from_numpy(tok),
                              scale_by_dim=True),
                jlayers.embed({"table": tab}, jnp.asarray(tok),
                              scale_by_dim=True))
    h, th = both(rng.standard_normal((2, 16, 64)))
    k, tk = both(rng.standard_normal((64, 50)) / 8)
    return (tlayers.unembed({"kernel": tk}, th),
            jlayers.unembed({"kernel": k}, h))


@pytest.mark.parametrize("layer", ("rmsnorm", "rope", "mrope", "embed",
                                   "unembed"))
def test_bfloat16_layer_casts_match_reference(layer):
    """The layers' casts in bfloat16, which the logits cannot show (over 28
    layers bfloat16 parts from float32 by ~5% of the logits' RMS in the
    reference itself): rmsnorm's float32 statistics and cast back, RoPE's
    and M-RoPE's float32 rotation, the embedding's scale give the
    reference's bfloat16 bits exactly; the unembedding's logits are float32
    (a bfloat16 product would part by ~2^-9), within 1e-6 x RMS."""
    got, want = _bf16_case(layer, np.random.default_rng(11))
    want = np.asarray(want.astype(jnp.float32))
    if layer == "unembed":
        assert got.dtype == torch.float32
        rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
        assert float(np.max(np.abs(got.numpy() - want))) <= 1e-6 * rms
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


def _drift(forward, pb, pf, cfg, toks) -> float:
    """max |bfloat16 logits - float32 logits| / RMS(float32 logits):
    ``forward`` of the bfloat16 weights ``pb`` and of the same widened to
    float32 (``pf``)."""
    lb = np.asarray(forward(pb, cfg, toks), np.float64)
    lf = np.asarray(forward(pf, dataclasses.replace(
        cfg, param_dtype="float32", activ_dtype="float32"), toks),
        np.float64)
    return float(np.max(np.abs(lb - lf)) / np.sqrt(np.mean(lf ** 2)))


@pytest.mark.parametrize("depth", (3, 28))
def test_bfloat16_drift_from_float32_is_the_reference_s(depth):
    """qwen3-0.6b reduced in bfloat16 at ``depth`` layers drifts from its
    own float32 run on the same weights as the reference's does: the
    port's drift within 1.25x the reference's (or 5e-3) on the same
    weights.  At 28 layers the reference's own drift is ~5% of the RMS,
    which sets chip_smoke's full-width bfloat16 hold against float32
    (``SERVE_BF16_TOL``, 1e-1).  The casts themselves are held bit for bit
    by ``test_bfloat16_layer_casts_match_reference``."""
    over = dict(param_dtype="bfloat16", activ_dtype="bfloat16",
                n_layers=depth, n_blocks=depth)
    jcfg = dataclasses.replace(jreg.get_reduced("qwen3-0.6b"), **over)
    tcfg = dataclasses.replace(treg.get_reduced("qwen3-0.6b"), **over)
    tp = init_params(tm.model_defs(tcfg), 3, "cpu", torch.bfloat16)
    tp32 = init_params(tm.model_defs(tcfg), 3, "cpu", torch.bfloat16).float()
    jp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16),
                      tp.tree())
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    toks = np.random.default_rng(depth).integers(0, tcfg.vocab, (B, S))

    def jfwd(p, cfg, t):
        jc = dataclasses.replace(jcfg, param_dtype=cfg.param_dtype,
                                 activ_dtype=cfg.activ_dtype)
        return jm.forward(p, jc, {"tokens": jnp.asarray(t, jnp.int32)})[0]

    def tfwd(p, cfg, t):
        with torch.inference_mode():
            return tm.forward(p, cfg, {"tokens": torch.from_numpy(
                t).long()})[0].numpy()

    ref = _drift(jfwd, jp, jp32, jcfg, toks)
    port = _drift(tfwd, tp, tp32, tcfg, toks)
    print(f"depth {depth}: drift port {port:.5f} reference {ref:.5f}")
    assert port <= max(1.25 * ref, ref + 5e-3)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_full_size_matches_reference(arch):
    """Shape arithmetic at the published widths: nothing is allocated."""
    assert treg.param_count(treg.get_config(arch)) == \
        jreg.param_count(jreg.get_config(arch))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_active_param_count_matches_reference(arch):
    """Active parameters a token at the published widths (MoE: top_k of
    the experts); qwen3-moe-235b-a22b's are its name's 22 B."""
    cfg = treg.get_config(arch)
    got = treg.active_param_count(cfg)
    assert got == jreg.active_param_count(jreg.get_config(arch))
    if arch == "qwen3-moe-235b-a22b":
        assert 20e9 <= got <= 25e9
    if not cfg.n_experts:
        assert got == treg.param_count(cfg)


def test_registry_mirrors_reference():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.LONG_CONTEXT_ARCHS == jreg.LONG_CONTEXT_ARCHS
    assert list(treg.cells(True)) == list(jreg.cells(True))
    for arch in treg.ARCH_IDS:
        for get in ("get_config", "get_reduced"):
            tc = dataclasses.asdict(getattr(treg, get)(arch))
            jc = dataclasses.asdict(getattr(jreg, get)(arch))
            assert tc == jc, (arch, get)
    cfg = treg.get_config("qwen3-0.6b")
    assert cfg.pdtype() == torch.bfloat16 and cfg.adtype() == torch.bfloat16


def test_params_from_numpy_checks_keys_and_shapes():
    cfg = treg.get_reduced("smollm-135m")
    jp = jax.tree.map(np.asarray, jinit(jm.model_defs(jreg.get_reduced(
        "smollm-135m")), jax.random.PRNGKey(0)))
    sd = params_from_numpy(jp, cfg, "cpu").state_dict()
    assert "blocks.sub0.attn.q" in sd and sd["blocks.sub0.attn.q"].shape == \
        (cfg.n_blocks, cfg.d_model, cfg.n_heads, cfg.head_dim)
    bad = jax.tree.map(lambda a: a, jp)
    bad["blocks"]["sub0"]["attn"]["qq"] = bad["blocks"]["sub0"]["attn"].pop(
        "q")
    with pytest.raises(ValueError, match="qq"):
        params_from_numpy(bad, cfg, "cpu")
    bad = jax.tree.map(lambda a: a, jp)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(bad, cfg, "cpu")
    bad = jax.tree.map(lambda a: a, jp)
    bad["embed"]["table"] = bad["embed"]["table"][:, :-1]
    with pytest.raises(ValueError, match="embed.table"):
        params_from_numpy(bad, cfg, "cpu")


def test_model_entry_points_default_to_the_card():
    """``init_params``, ``init_caches`` and ``params_from_numpy`` place
    their tensors on the card unless the caller passes ``"cpu"``; without
    a card they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would use it")
    cfg = treg.get_reduced("smollm-135m")
    jp = jax.tree.map(np.asarray, jinit(jm.model_defs(jreg.get_reduced(
        "smollm-135m")), jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(tm.model_defs(cfg), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_caches(cfg, B, S)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(jp, cfg)
    p = init_params(tm.model_defs(cfg), 0, "cpu")
    assert all(t.device.type == "cpu" for t in p.state_dict().values())
    c = tm.init_caches(cfg, B, S, device="cpu")
    assert c["blocks"]["sub0"].k.device.type == "cpu"


_INIT_PROBE = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.configs.registry import get_reduced
from repro_torch.models.model import model_defs
from repro_torch.models.params import init_params
p = init_params(model_defs(get_reduced("qwen3-0.6b")), 7, "cpu")
print(float(sum(t.double().abs().sum() for t in p.state_dict().values())))
"""


def test_init_params_stable_across_processes():
    """The port seeds each leaf from crc32 of its path, so a seed gives the
    same weights in every process (the reference's ``hash`` fold is salted
    per process).  Two processes with other hash seeds, and this one."""
    sums = []
    for salt in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=salt)
        out = subprocess.run(
            [sys.executable, "-c", _INIT_PROBE.format(src=os.path.join(
                ROOT, "src"))], env=env, capture_output=True, text=True,
            timeout=300, check=True)
        sums.append(float(out.stdout.strip()))
    p = init_params(tm.model_defs(treg.get_reduced("qwen3-0.6b")), 7, "cpu")
    here = float(sum(t.double().abs().sum() for t in p.state_dict().values()))
    assert sums == [here, here]
    assert path_seed(7, ("a", "b")) != path_seed(7, ("a", "c"))
    q = p.tree()["blocks"]["sub0"]["attn"]["q"]
    # normal x 1 / sqrt(fan_in): the reference's "linear" init
    assert abs(float(q.std()) * np.sqrt(q.shape[1]) - 1.0) < 0.05
    assert torch.equal(p.tree()["final_norm"]["scale"],
                       torch.ones(q.shape[1]))


def test_init_params_seed_changes_every_drawn_leaf():
    """Each seed draws other weights in every random leaf: the seed is
    folded into the 32 bits torch's CPU generator keeps (a seed above them
    was dropped, and every seed gave seed 0's weights)."""
    defs = tm.model_defs(treg.get_reduced("qwen3-0.6b"))
    a, b = (init_params(defs, s, "cpu").state_dict() for s in (0, 1))
    drawn = [k for k, t in a.items() if not (torch.all(t == 0)
                                            or torch.all(t == 1))]
    assert drawn and all(not torch.equal(a[k], b[k]) for k in drawn)
    assert path_seed(0, ("a",)) != path_seed(1, ("a",)) < 2 ** 32
