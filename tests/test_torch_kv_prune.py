"""The port's KV-cache pruning (``repro_torch.serving.kv_prune``) against the
JAX package's, on the CPU.

``importance_series`` sums the keys' squares in XLA's row-reduce order,
divides once and roots correctly rounded, so it equals strict-compiled JAX
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``,
ROADMAP C1) bit for bit; ``select_positions`` runs the port's
``compress_batch`` where the reference vmaps ``compress_rounds``, and keeps
the same slots.  XLA's default compilation sums the norms in another order
(vectorized), so its series parts from the port's in the last bits
(ROADMAP C18); the kept slots are still equal on these cases.  The JAX side
runs in two subprocesses, strict and default, started by the module's
first test.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as jget
from repro.data.pipeline import token_batch
from repro.models import attention as jattn
from repro.models import model as jm
from repro.models.params import init_params as jinit
from repro.serving import kv_prune as jkv
from repro_torch.configs.registry import get_reduced as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as tm
from repro_torch.models.attention import KVCache
from repro_torch.serving import kv_prune as tkv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
# (lanes, positions, kv heads, head dim, keep): qwen3-0.6b's heads last
SEL_CASES = ((2, 64, 2, 8, 16), (6, 36, 2, 32, 12), (3, 200, 1, 32, 50),
             (2, 520, 8, 128, 128))
ARCH = "qwen3-0.6b"
PB, PS, PEXTRA, PKEEP = 2, 64, 8, 16     # the pruned prefill cache
# the reference's weights by the str hash seed of its process: under seed
# 2's a separately rounded Eq. 9 window keeps another slot in one lane
# (C19); under seed 4's a vmapped lane parts from its solo run (C11)
HASH_SEEDS = {"strict": "2", "strict_c11": "4"}
FIELDS = ("k", "v", "pos_ids", "k_scale", "v_scale")


def _keys(case, seed=0):
    B, S, K, dh, _ = case
    rng = np.random.default_rng(seed + 10 * S)
    scale = np.exp(0.3 * rng.standard_normal((B, S, 1, 1)))
    return (rng.standard_normal((B, S, K, dh)) * scale).astype(np.float32)


def _int8_keys():
    q, s = jattn._quantize_kv(jnp.asarray(_keys(SEL_CASES[1], seed=3)))
    return np.asarray(q), np.asarray(s)


def _jcache(k, k_scale=None):
    B, S = k.shape[:2]
    one = jnp.ones((1,), jnp.float32)
    ks = one if k_scale is None else jnp.asarray(k_scale)
    return jattn.KVCache(k=jnp.asarray(k), v=jnp.asarray(k),
                         pos_ids=jnp.broadcast_to(jnp.arange(S), (B, S)),
                         k_scale=ks, v_scale=ks)


def _tcache(k, k_scale=None):
    B, S = k.shape[:2]
    one = torch.ones(1)
    ks = one if k_scale is None else torch.from_numpy(np.array(k_scale))
    kt = torch.from_numpy(np.array(k, copy=True))
    return KVCache(k=kt, v=kt, pos_ids=torch.arange(S).expand(B, S),
                   k_scale=ks, v_scale=ks)


def _prefill_inputs():
    cfg = jget(ARCH)
    params = jinit(jm.model_defs(cfg), jax.random.PRNGKey(0))
    return cfg, params, token_batch(cfg, PB, PS, step=0)


# ---------------------------------------------------------------------------
# the JAX side, in subprocesses
# ---------------------------------------------------------------------------

class _SoloJax:
    """``jax`` with ``vmap`` run as a loop of single-lane calls: the
    reference's ``select_positions`` then ranks each lane by its solo
    ``compress_rounds``, which its vmapped lanes are meant to equal and do
    not always (ROADMAP C11)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def vmap(fn):
        def run(xs):
            outs = [fn(x) for x in xs]
            return jax.tree.map(lambda *a: jnp.stack(a), *outs)
        return run


def _reference_main(out, prune_only=False):
    """Series and selections of every case; the int8 series; a reduced
    model's stacked prefill cache, its ``prune_tree`` (vmapped, as the
    reference runs it, and lane by lane) and a decode step on the pruned
    cache (``prune_only``: the cache and its prunes)."""
    res = {}
    for i, case in enumerate(() if prune_only else SEL_CASES):
        c = _jcache(_keys(case))
        res[f"sig/{i}"] = np.asarray(jax.jit(jkv.importance_series)(c))
        res[f"idx/{i}"] = np.asarray(jkv.select_positions(c, case[-1]))
    if not prune_only:
        q, s = _int8_keys()
        res["sig/int8"] = np.asarray(jax.jit(jkv.importance_series)(
            _jcache(q, s)))
    cfg, params, batch = _prefill_inputs()
    _, caches = jax.jit(lambda p, b: jm.prefill(
        p, cfg, b, max_len=PS + PEXTRA))(params, batch)
    pruned = jkv.prune_tree(caches, PKEEP)
    jkv.jax = _SoloJax()
    solo = jkv.prune_tree(caches, PKEEP)
    jkv.jax = jax
    for f in FIELDS:
        res[f"cache/{f}"] = np.asarray(getattr(caches["blocks"]["sub0"], f))
        res[f"pruned/{f}"] = np.asarray(getattr(pruned["blocks"]["sub0"], f))
        res[f"solo/{f}"] = np.asarray(getattr(solo["blocks"]["sub0"], f))
    logits, _ = jax.jit(lambda p, t, c: jm.decode_step(
        p, cfg, t, c, jnp.asarray(PS, jnp.int32)))(
            params, batch["tokens"][:, :1], pruned)
    res["pruned/logits"] = np.asarray(logits)
    # the reference folds hash(path) into its keys, salted per process
    # (src/repro_torch/README.md, "Init"): its weights cross with the
    # results
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        res["param/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    np.savez(out, **res)


class _Reference:
    """A JAX subprocess started when the module's first test asks, read
    when a test needs its results."""

    def __init__(self, kind, out):
        # the reference folds the salted str hash into its weights' keys: a
        # fixed hash seed gives the same weights, and prefill cache, in
        # every run
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
                   PYTHONPATH=os.path.join(ROOT, "src"),
                   PYTHONHASHSEED=HASH_SEEDS.get(kind, HASH_SEEDS["strict"]))
        env.pop("XLA_FLAGS", None)
        if kind.startswith("strict"):
            env["XLA_FLAGS"] = STRICT_XLA_FLAGS
        self.out = out
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out,
             *(["--prune-only"] if kind == "strict_c11" else [])], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.data = None

    def __call__(self):
        if self.data is None:
            log, _ = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, log
            with np.load(self.out) as z:
                self.data = {k: z[k] for k in z.files}
        return self.data

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_kv_prune")
    out = {kind: _Reference(kind, str(tmp / f"{kind}.npz"))
           for kind in ("strict", "default", "strict_c11")}
    yield out
    for r in out.values():
        r.close()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# against the strict-compiled reference, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SEL_CASES)))
def test_importance_series_equals_strict_reference(refs, i):
    got = tkv.importance_series(_tcache(_keys(SEL_CASES[i])))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(refs["strict"]()[f"sig/{i}"]))


def test_importance_series_int8_equals_strict_reference(refs):
    q, s = _int8_keys()
    got = tkv.importance_series(_tcache(q, s))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(refs["strict"]()["sig/int8"]))


@pytest.mark.parametrize("i", range(len(SEL_CASES)))
def test_select_positions_equals_strict_reference(refs, i):
    case = SEL_CASES[i]
    idx = tkv.select_positions(_tcache(_keys(case)), case[-1])
    assert idx.shape == (case[0], case[-1])
    np.testing.assert_array_equal(idx.numpy(), refs["strict"]()[f"idx/{i}"])


def test_default_compilation_parts_series_not_selection(refs):
    """ROADMAP C18: default-compiled XLA sums the key norms in another
    order, so its series parts from the port's (and strict JAX's) in the
    last bits, by a few ulp at most; on these cases every kept slot is
    still the same."""
    parted, total = 0, 0
    for i, case in enumerate(SEL_CASES):
        got = tkv.importance_series(_tcache(_keys(case))).numpy()
        want = refs["default"]()[f"sig/{i}"]
        ulp = np.abs(_bits(got).astype(np.int64) - _bits(want))
        assert ulp.max() <= 4, (case, ulp.max())
        parted += int(np.sum(ulp > 0))
        total += got.size
        idx = tkv.select_positions(_tcache(_keys(case)), case[-1])
        np.testing.assert_array_equal(idx.numpy(),
                                      refs["default"]()[f"idx/{i}"])
    assert parted > 0, "the default compilation now sums in the port's order"
    assert parted < total


@pytest.mark.parametrize("kind", ("strict", "strict_c11"))
def test_prune_tree_stacked_cache_equals_strict_reference(refs, kind):
    """A reduced model's stacked prefill cache ``[3, B, 72]`` (8 padding
    slots: pos_ids -1, zero keys, kept in the series as in the reference):
    ``prune_tree`` folds the block axis into 6 lanes of one
    ``compress_batch``; every field equals JAX's lane-by-lane selection bit
    for bit, and its vmapped selection on every lane where that equals the
    lane's solo run (C11).  Among the ranking keys the padding's zero
    impacts tie, so the float32 Eq. 9 windows must carry the reference's
    fused interpolation (C19): with separate roundings the port keeps
    another slot in one lane of the "strict" weights; in the "strict_c11"
    ones a vmapped lane parts from its solo run."""
    want = refs[kind]()
    cache = KVCache(*(torch.from_numpy(np.array(want[f"cache/{f}"],
                                                copy=True))
                      for f in FIELDS))
    assert cache.k.shape[:3] == (tget(ARCH).n_blocks, PB, PS + PEXTRA)
    assert int(torch.sum(cache.pos_ids < 0)) == 3 * PB * PEXTRA
    pruned = tkv.prune_tree({"blocks": {"sub0": cache}}, PKEEP)
    got = pruned["blocks"]["sub0"]
    assert got.k.shape == (3, PB, PKEEP) + cache.k.shape[3:]
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(want[f"solo/{f}"]), err_msg=f)
    # lanes whose vmapped selection parts from their solo one (C11)
    lanes = tuple(want["solo/pos_ids"].shape[:2])
    c11 = np.any(want["pruned/pos_ids"] != want["solo/pos_ids"], axis=-1)
    port = np.any(got.pos_ids.numpy() != want["pruned/pos_ids"], axis=-1)
    assert c11.shape == lanes and np.array_equal(port, c11)
    assert c11.any() == (kind == "strict_c11")


def _params_of(want) -> dict:
    """The subprocess's parameter tree, nested."""
    tree = {}
    for key, a in want.items():
        if key.startswith("param/"):
            *path, leaf = key.split("/")[1:]
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    return tree


def test_decode_after_pruning_matches_reference(refs):
    """A decode step at position S on the pruned cache (its write lands at
    S % keep, over a kept entry, as in the reference) within 2e-4."""
    want = refs["strict"]()
    _, _, batch = _prefill_inputs()
    tp = params_from_numpy(_params_of(want), tget(ARCH), "cpu")
    pruned = {"blocks": {"sub0": KVCache(*(torch.from_numpy(
        np.array(want[f"pruned/{f}"], copy=True)) for f in FIELDS))}}
    tok = torch.from_numpy(np.array(batch["tokens"][:, :1])).long()
    logits, _ = tm.decode_step(tp, tget(ARCH), tok, pruned, PS)
    np.testing.assert_allclose(logits.numpy(), want["pruned/logits"],
                               rtol=2e-4, atol=2e-4)


def test_prune_tree_of_port_prefill_then_decode():
    """The port end to end on the CPU: prefill, ``prune_tree``, decode
    steps on the compacted cache."""
    cfg = tget(ARCH)
    _, params, batch = _prefill_inputs()
    tp = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    tokens = torch.from_numpy(np.array(batch["tokens"])).long()
    _, caches = tm.prefill(tp, cfg, {"tokens": tokens}, max_len=PS + PEXTRA)
    pruned = tkv.prune_tree(caches, PKEEP)
    c = pruned["blocks"]["sub0"]
    assert c.k.shape[2] == PKEEP
    # the first and last slots are always kept (CAMEO keeps the endpoints)
    assert bool((c.pos_ids[:, :, 0] == 0).all())
    for i in range(3):
        logits, pruned = tm.decode_step(tp, cfg, tokens[:, i:i + 1], pruned,
                                        PS + i)
        assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the reference's own cases, on the port
# ---------------------------------------------------------------------------

def test_kv_prune_selects_impulses_and_compacts():
    rng = np.random.default_rng(0)
    B, size, K, dh = 2, 64, 2, 8
    k = 0.05 * rng.standard_normal((B, size, K, dh)).astype(np.float32)
    impulses = [7, 23, 40, 57]
    for i in impulses:
        k[:, i] *= 40.0
    cache = _tcache(k)
    idx = tkv.select_positions(cache, keep=16)
    assert idx.shape == (B, 16)
    for b in range(B):
        for i in impulses:
            assert i in idx[b].tolist(), (b, i, idx[b])
    small = tkv.compact_cache(cache, idx)
    assert small.k.shape == (B, 16, K, dh)
    # kept entries are bit-exact copies
    np.testing.assert_array_equal(small.k[0, 0].numpy(), k[0, int(idx[0, 0])])


def test_kv_prune_noop_is_exact():
    rng = np.random.default_rng(1)
    size = 16
    k = rng.standard_normal((2, size, 2, 4)).astype(np.float32)
    cache = _tcache(k)
    idx = tkv.select_positions(cache, keep=size)
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(size),
                                                       (2, 1)))
    np.testing.assert_array_equal(tkv.compact_cache(cache, idx).k.numpy(), k)


def test_importance_series_tracks_key_norm():
    k = np.zeros((1, 8, 1, 4), np.float32)
    k[0, 3] = 10.0
    assert int(torch.argmax(tkv.importance_series(_tcache(k)))) == 3


def test_compact_cache_bits_equal_reference():
    """An int8 cache's values and scales gathered at the same slots: the
    port's compaction equals JAX's bit for bit; the placeholder scales of a
    float cache pass through."""
    q, s = _int8_keys()
    B, S = q.shape[:2]
    idx = np.sort(np.random.default_rng(5).permutation(S)[:10])
    idx = np.tile(idx, (B, 1)).astype(np.int32)
    want = jkv.compact_cache(_jcache(q, s), jnp.asarray(idx))
    got = tkv.compact_cache(_tcache(q, s), torch.from_numpy(idx))
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(getattr(want, f)), err_msg=f)
    plain = tkv.compact_cache(_tcache(_keys(SEL_CASES[1])),
                              torch.from_numpy(idx))
    assert plain.k_scale.shape == (1,)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    _reference_main(sys.argv[1], prune_only="--prune-only" in sys.argv)
