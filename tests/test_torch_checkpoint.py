"""The port's checkpoint manager (``repro_torch.checkpoint.manager``)
against the JAX package's, on the CPU: the reference's six
``tests/test_checkpoint.py`` properties on the port, the same on-disk
format (keys in ``jax.tree_util``'s order, shapes, dtypes and the sha256
of the uncompressed archive), each side restoring the other's float32
checkpoint, the port restoring bfloat16 checkpoints from both, and C22:
the reference's own ``restore(template=)`` cannot read back the
bfloat16 leaves it wrote.

``np.savez`` stamps each archive member with the wall clock's second, so
the two managers' archives are byte-equal only when written in the same
second: the format tests hold the clock still (``time.time``) while both
write.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jck
from repro.optim import adamw as jadam
from repro_torch.checkpoint import manager as tck
from repro_torch.models.params import ParamTree
from repro_torch.optim import adamw as tadam
from repro_torch.tree import leaves


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 8))),
            "b": {"c": torch.from_numpy(rng.normal(size=(3,))),
                  "d": torch.tensor(7, dtype=torch.int32)}}


# ---------------------------------------------------------------------------
# the reference's properties, on the port
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    tck.save(str(tmp_path), 5, t)
    assert tck.latest_step(str(tmp_path)) == 5
    restored, manifest = tck.restore(str(tmp_path), 5, template=t)
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert manifest["step"] == 5


def test_keep_k(tmp_path):
    t = _tree()
    for s in [1, 2, 3, 4, 5]:
        tck.save(str(tmp_path), s, t, keep=2)
    assert tck.all_steps(str(tmp_path)) == [4, 5]


def test_corruption_detected(tmp_path):
    t = _tree()
    path = tck.save(str(tmp_path), 1, t)
    with open(os.path.join(path, "manifest.json")) as f:
        codec = json.load(f)["codec"]
    arr = os.path.join(path, tck._array_file(codec))
    raw = tck._decompress_bytes(open(arr, "rb").read(), codec)
    bad = bytearray(raw)
    bad[100] ^= 0xFF
    open(arr, "wb").write(tck._compress_bytes(bytes(bad), codec))
    with pytest.raises(IOError, match="checksum"):
        tck.restore(str(tmp_path), 1, template=t)


def test_partial_save_ignored(tmp_path):
    t = _tree()
    tck.save(str(tmp_path), 1, t)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert tck.latest_step(str(tmp_path)) == 1


def test_async_save(tmp_path):
    t = _tree(3)
    th = tck.save_async(str(tmp_path), 9, t)
    th.join()
    restored, _ = tck.restore(str(tmp_path), 9, template=t)
    assert torch.equal(restored["a"], t["a"])


def test_restore_casts_dtype_template(tmp_path):
    t = {"w": torch.ones(4, dtype=torch.float32)}
    tck.save(str(tmp_path), 1, t)
    tpl = {"w": torch.empty(4, dtype=torch.bfloat16)}
    restored, _ = tck.restore(str(tmp_path), 1, template=tpl)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.ones(4))


# ---------------------------------------------------------------------------
# the reference's format
# ---------------------------------------------------------------------------

def _pair(dtype=np.float32, seed=1):
    """The same (params, AdamW state) pair for both packages: the JAX
    tree and the port's (a ParamTree and its AdamWState)."""
    rng = np.random.default_rng(seed)
    params = {"embed": {"table": rng.normal(size=(6, 4))},
              "blocks": {"sub0": {"w": rng.normal(size=(2, 4, 3)),
                                  "scale": rng.normal(size=(2, 4))}},
              "head": rng.normal(size=(4, 6))}
    m = jax.tree.map(lambda a: a * 0.1, params)
    v = jax.tree.map(lambda a: a * a, params)
    jt = jnp.bfloat16 if dtype == "bfloat16" else dtype

    def j(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32).astype(jt),
                            tree)

    def t(tree):
        return jax.tree.map(lambda a: torch.from_numpy(np.array(
            jnp.asarray(a, jnp.float32).astype(jt).astype(jnp.float32)
        )).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32),
            tree)
    jpair = (j(params), jadam.AdamWState(m=j(m), v=j(v),
                                          step=jnp.asarray(3, jnp.int32)))
    tpair = (ParamTree(t(params)),
             tadam.AdamWState(m=t(m), v=t(v),
                              step=torch.tensor(3, dtype=torch.int32)))
    return jpair, tpair


def test_format_matches_reference(tmp_path, monkeypatch):
    """A float32 and int32 tree saved by both managers in the same second:
    the same manifest keys (the reference's tree paths), shapes, dtypes and
    sha256."""
    jpair, tpair = _pair()
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.save(jdir, 2, jpair)
    tck.save(tdir, 2, tpair)
    man = [json.load(open(os.path.join(d, "step_00000002", "manifest.json")))
           for d in (jdir, tdir)]
    assert "0/embed/table" in man[0]["keys"]
    assert "1/.m/blocks/sub0/w" in man[0]["keys"]
    assert man[0]["keys"]["1/.step"] == {"shape": [], "dtype": "int32"}
    assert list(man[1]["keys"]) == list(man[0]["keys"])
    assert man[1]["keys"] == man[0]["keys"]
    assert man[1]["checksum"] == man[0]["checksum"]
    assert man[1]["codec"] == man[0]["codec"]


def test_each_restores_the_others_float32(tmp_path):
    jpair, tpair = _pair()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.save(jdir, 4, jpair)
    tck.save(tdir, 4, tpair)
    got, _ = tck.restore(jdir, 4, template=tpair)
    assert isinstance(got[0], ParamTree) and isinstance(got[1],
                                                        tadam.AdamWState)
    for a, b in zip(leaves(got), leaves(tpair)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back, _ = jck.restore(tdir, 4, template=jpair)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jpair)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_restores_bfloat16_from_both(tmp_path, monkeypatch):
    """bfloat16 leaves are written as the reference writes them (2-byte
    void, manifest dtype "bfloat16", the same archive bytes) and the port
    reads them back bit for bit, its own and the reference's."""
    jpair, tpair = _pair("bfloat16")
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.save(jdir, 1, jpair)
    tck.save(tdir, 1, tpair)
    man = [json.load(open(os.path.join(d, "step_00000001", "manifest.json")))
           for d in (jdir, tdir)]
    assert man[0]["keys"]["0/head"]["dtype"] == "bfloat16"
    assert man[1]["keys"] == man[0]["keys"]
    assert man[1]["checksum"] == man[0]["checksum"]
    for d in (jdir, tdir):
        got, _ = tck.restore(d, 1, template=tpair)
        for a, b in zip(leaves(got), leaves(tpair)):
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b)
    raw, _ = tck.restore(jdir, 1)
    assert raw["0/head"].dtype == torch.bfloat16


def test_reference_cannot_restore_its_own_bfloat16(tmp_path):
    """C22: ``np.savez`` keeps ml_dtypes' bfloat16 as 2-byte void, and the
    reference's ``restore(template=)`` (``checkpoint/manager.py:204``)
    then calls ``astype(bfloat16)`` on the void array, which has no cast.
    The first input: a 3-value bfloat16 tree."""
    t = {"w": jnp.asarray([1.0, 2.0, 3.0], jnp.bfloat16)}
    jck.save(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="cast"):
        jck.restore(str(tmp_path), 1, template=t)
    got, _ = tck.restore(str(tmp_path), 1,
                         template={"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert got["w"].tolist() == [1.0, 2.0, 3.0]
