"""The serving slice on the card against the CPU path, and
``chip_smoke.run_serving`` rehearsed tiny on the CPU.

This file imports no JAX: its ``gpu`` tests (skipped without a card) hold
the card's reduced-model logits and greedy tokens, and its importance
series and KV selection through the CUDA kernels, to the same calls on the
CPU.
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.kernels import lag_dot
from repro_torch.models.attention import KVCache
from repro_torch.models.model import forward, model_defs
from repro_torch.models.params import init_params
from repro_torch.serving import kv_prune
from repro_torch.serving.engine import Engine, ServeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(reduced=True, attn_chunk=16, B=2, S=32, new=4, cache_B=2,
            cache_prefill=16, cache_steps=4, keep=12, pruned_steps=2,
            small_B=2, small_S=16, small_new=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


def test_chip_smoke_serving_rehearsal():
    """chip_smoke.py's serving phase at a tiny size on the CPU, where every
    wrapper takes its plain version: qwen3-0.6b reduced with attn_chunk 16
    (the chunked prefill at S = 32, the unchunked one at 16), every step
    and hold runs (the generation's logits against the unchunked forward's
    too), no kernel is counted."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    lines = []
    out = chip_smoke.run_serving("cpu", sizes=TINY, log=lines.append)
    steps = [r["step"] for r in out["rows"]]
    assert steps == ["generate", "kv_prune", "bf16_vs_float32", "cache_path",
                     "small"]
    assert len(lines) == 5 and all(ln.startswith("serve {") for ln in lines)
    gen, sel, held, cache, small = out["rows"]
    assert gen["chunked_prefill"] and gen["deterministic"]
    assert gen["tokens_per_s"] > 0 and gen["max_memory_allocated"] is None
    assert sel["lanes"] == 3 * 2 and sel["positions"] == 32 + 4
    assert sel["held_layers"] == [0, 2] and sel["kept_equal_cpu"]
    assert sel["rounds_total"] > 0
    assert held["max_abs_err"] <= held["tol"] * held["logits_rms"]
    assert held["B"] == 2 and held["tokens_parted_sure"] == 0
    assert cache["max_abs_err"] <= cache["tol"] * cache["logits_rms"]
    assert small["rows_equal"] == 2
    assert set(out["launches"].values()) == {0}


# the MoE and Mamba2 phase tiny: the reduced configs, qwen3-moe at two
# layers with the chunked prefill forced (attn_chunk 16 at S = 32)
TINY_ZOO = dict(
    reduced=True,
    moe=dict(layers=2, attn_chunk=16, B=2, S=32, new=4, keep=12,
             pruned_steps=2, cache_B=2, cache_prefill=16, cache_steps=4,
             a2a_B=2, a2a_S=16),
    mamba=dict(B=2, S=32, new=4, cache_B=2, cache_prefill=20,
               cache_steps=4),
    small=dict(small_B=2, small_S=16, small_new=4))


def test_chip_smoke_serving_zoo_rehearsal():
    """chip_smoke.py's MoE and Mamba2 phase at a tiny size on the CPU:
    qwen3-moe's generation, its per-layer drops at prefill, the KV
    selection, the float32 cache path and ``moe_apply_a2a`` on a gloo rank;
    mamba2's generation and cache path (a prefill ending inside a chunk);
    the four reduced configs against themselves; no kernel is counted."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    lines = []
    out = chip_smoke.run_serving_zoo("cpu", sizes=TINY_ZOO, log=lines.append)
    steps = [(r["step"], r.get("arch", "")[:5]) for r in out["rows"]]
    assert steps == [("generate", "qwen3"), ("kv_prune", ""),
                     ("cache_path", "qwen3"), ("moe_a2a", "qwen3"),
                     ("generate", "mamba"), ("cache_path", "mamba")] + \
        [("small", a[:5]) for a in chip_smoke.SERVE_ZOO_SMALL]
    assert all(ln.startswith("serve {") for ln in lines)
    gen, sel, cache, a2a, mgen, mcache = out["rows"][:6]
    assert gen["chunked_prefill"] and len(gen["dropped_at_prefill"]) == 2
    assert gen["capacity"] == 16 and gen["assignments_a_layer"] == 2 * 32 * 2
    assert sel["lanes"] == 2 * 2 and sel["kept_equal_cpu"]
    for row in (cache, a2a, mcache):
        assert row["max_abs_err"] <= row["tol"] * row.get(
            "logits_rms", row.get("rms"))
    assert cache["layers"] == 1 and a2a["backend"] == "gloo"
    assert not mgen["chunked_prefill"] and mcache["prefill_S"] == 20
    for small in out["rows"][6:]:
        assert small["rows_equal"] == 2
        if "moe" in small["arch"] or "kimi" in small["arch"]:
            assert small["routes_parted"] == 0
    assert set(out["launches"].values()) == {0}


def _keys(B, S, K, dh, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.exp(0.3 * rng.standard_normal((B, S, 1, 1)))
    return (rng.standard_normal((B, S, K, dh)) * scale).astype(np.float32)


def _cache(k: torch.Tensor) -> KVCache:
    B, S = k.shape[:2]
    one = torch.ones(1, device=k.device)
    return KVCache(k=k, v=k, pos_ids=torch.arange(S, device=k.device).expand(
        B, S), k_scale=one, v_scale=one)


@pytest.mark.gpu
def test_gpu_select_positions_equals_cpu(cuda):
    """qwen3-0.6b's key heads (8 x 128), bfloat16 keys: the card's series
    bit for bit and its kept slots equal the CPU path's, through the
    kernels (lag_dot counted)."""
    k = torch.from_numpy(_keys(6, 520, 8, 128)).bfloat16()
    want_sig = kv_prune.importance_series(_cache(k))
    want = kv_prune.select_positions(_cache(k), 128)
    kc = k.to(cuda)
    got_sig = kv_prune.importance_series(_cache(kc)).cpu()
    assert torch.equal(got_sig.view(torch.int32), want_sig.view(torch.int32))
    before = lag_dot.lag_dot_cuda.launches
    got = kv_prune.select_positions(_cache(kc), 128)
    assert lag_dot.lag_dot_cuda.launches > before
    assert torch.equal(got.cpu(), want)
    small = kv_prune.compact_cache(_cache(kc), got)
    assert torch.equal(small.k.cpu(), kv_prune.compact_cache(
        _cache(k), want).k)


@pytest.mark.gpu
def test_gpu_reduced_model_equals_cpu(cuda):
    """qwen3-0.6b reduced (float32, TF32 off) from one seed on both devices:
    logits within 1e-4 x RMS, greedy tokens equal."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_reduced("qwen3-0.6b")
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, size=(3, 40)).astype(np.int32)
        out = {}
        for where in ("cpu", cuda):
            params = init_params(model_defs(cfg), 0, where)
            toks = Engine(cfg, params, ServeConfig(max_new_tokens=8),
                          device=where).generate(prompts)
            seq = torch.from_numpy(np.concatenate([prompts, toks], 1)).long()
            logits, _ = forward(params, cfg, {"tokens": seq.to(where)})
            out[str(where)] = (toks, logits.cpu())
        (tc, lc), (td, ld) = out["cpu"], out[str(cuda)]
        rms = float(torch.sqrt(torch.mean(lc.double() ** 2)))
        assert float(torch.max(torch.abs(ld - lc))) <= 1e-4 * rms
        np.testing.assert_array_equal(td, tc)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_chip_smoke_serving_kernel_holds_rehearsal(monkeypatch):
    """chip_smoke's holds of the KV selection's kernels, rehearsed on the
    CPU: with the dispatch forced to the wrappers (which take their plain
    versions for CPU tensors), ``record_launches`` records every launch of
    each of the six kernels, or its first with ``limit=1`` (segment_cells'
    first with cells that are not all zero, ``SERVE_KEEP``), and
    ``serving_kernel_entries`` replays and holds each; the wrappers' counts
    are left as they were."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "resolve_backend",
                        lambda backend, device=None: "cuda")
    sig = kv_prune.importance_series(_cache(torch.from_numpy(
        _keys(6, 72, 2, 32))))
    before = chip_smoke.read_counts()
    with chip_smoke.record_launches(chip_smoke.SERVE_KERNELS) as every:
        idx = kv_prune.select_from_series(sig, 16)
    with chip_smoke.record_launches(chip_smoke.SERVE_KERNELS, limit=1,
                                    keep=chip_smoke.SERVE_KEEP) as rec:
        assert np.array_equal(kv_prune.select_from_series(sig, 16), idx)
    assert chip_smoke.read_counts() == before
    assert sorted(rec) == sorted(chip_smoke.SERVE_KERNELS)
    for kname, calls in rec.items():
        assert len(calls) == 1 and len(every[kname]) >= 1
        a, kw, out = calls[0]
        keep = chip_smoke.SERVE_KEEP.get(kname, lambda o: True)
        a0, kw0, out0 = next(c for c in every[kname] if keep(c[2]))
        # segment_cells gives a tuple of tensors, the others one tensor
        outs, outs0 = ((o,) if torch.is_tensor(o) else o for o in (out, out0))
        assert len(outs) == len(outs0) and kw.keys() == kw0.keys()
        assert all(torch.equal(u, v) for u, v in zip(outs, outs0))
    monkeypatch.undo()
    np.testing.assert_array_equal(idx, kv_prune.select_from_series(sig, 16))
    entries = chip_smoke.serving_kernel_entries(torch.device("cpu"), rec)
    assert sorted(e["name"] for e in entries) == sorted(rec)
    for e in entries:
        assert e["dataset"] == "serving" and e["lanes"] == 6
        assert e["max_abs_err"] == 0.0 and e["bound_ms"] > 0
        assert e["ms"] is None and e["bound_by"] in ("bytes", "operations")


def test_chip_smoke_recorder_keeps_the_counts(monkeypatch):
    """A wrapper that counts through its own module's name, which the
    recorder stands in for, still counts every launch on itself, also
    across a ``reset_counts`` inside the block (as ``phase_main`` does)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    mod = types.ModuleType("own_module")
    exec("def k(x):\n    k.launches += 1\n    return x + 1\n"
         "k.launches = 0\n", mod.__dict__)
    wrapper = mod.k
    monkeypatch.setitem(chip_smoke.WRAPPERS, "own", wrapper)
    monkeypatch.setitem(chip_smoke.CALLERS, "own", ((mod, "k"),))
    with chip_smoke.record_launches(["own"]) as got:
        mod.k(torch.tensor(0))
        chip_smoke.reset_counts()
        for i in range(3):
            mod.k(torch.tensor(i))
        assert chip_smoke.read_counts()["own"] == 3
    assert mod.k is wrapper and wrapper.launches == 3
    assert [int(c[2]) for c in got["own"]] == [1, 1, 2, 3]
