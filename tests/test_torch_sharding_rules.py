"""The port's logical-axis rules and spec layer (``repro_torch.sharding``'s
rule tables, ``models.params.param_specs``/``abstract_params``, the cache
specs, ``launch.specs``, ``launch.mesh``) against the JAX package's, on
process-free meshes.

For all ten configs, full width and reduced, on the meshes (2, 4),
(16, 16) and (2, 16, 16) (the reference's on ``jax.sharding.AbstractMesh``,
the port's on ``sharding.AbstractMesh``), under ``default_rules`` with
each switch flipped in turn: every parameter's spec is tuple-equal to the
reference's and its shard shape equals ``NamedSharding.shard_shape`` (or,
where one mesh axis lands on two dimensions of a tensor, as
``expert_axis="data"`` with FSDP or ``seq_shard``'s tokens do, both
refuse the sharding); the same for ``batch_specs`` (and so the decode caches' ``cache_specs``) of
every shape in ``SHAPES`` and for ``opt_state_abstract`` under AdamW
(parameter-typed and bfloat16 state) and Adafactor, dtypes included.
The reference's own cases (``tests/test_sharding.py:16-41``) run on the
port's rules.  Exact equality throughout: the rules are integer
arithmetic.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import NamedSharding as JNamed

from repro import sharding as jshd
from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.train.step import TrainConfig as JTrainConfig
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch import sharding as tshd
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.optim.adamw import AdamWConfig as TAdamWConfig
from repro_torch.train.step import TrainConfig as TTrainConfig
from repro_torch.tree import leaves as tleaves

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SWITCHES = {"default": {}, "no_fsdp": {"fsdp": False},
            "seq_shard": {"seq_shard": True},
            "expert_data": {"expert_axis": "data"},
            "pod_pipeline": {"pod_pipeline": True}}
CONFIGS = [(arch, red) for arch in treg.ARCH_IDS for red in (False, True)]


def _meshes(name):
    shape, axes = MESHES[name]
    return JMesh(shape, axes), tshd.AbstractMesh(shape, axes)


def _rules(name, switch):
    kw = dict(SWITCHES[switch], multi_pod="pod" in MESHES[name][1])
    return jshd.default_rules(**kw), tshd.default_rules(**kw)


def _cfgs(arch, reduced):
    if reduced:
        return jreg.get_reduced(arch), treg.get_reduced(arch)
    return jreg.get_config(arch), treg.get_config(arch)


def _flat(tree, path=()):
    """{path: leaf} of a nested dict (specs are tuples: leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _both(jfn, tfn):
    """(reference tree, port tree), or None where the reference's
    ``NamedSharding`` refuses a spec that maps one mesh axis to two
    dimensions, after checking that the port refuses it too."""
    try:
        jtree = jfn()
    except Exception as e:
        assert type(e).__name__ == "DuplicateSpecError", e
        with pytest.raises(ValueError, match="more than one"):
            tfn()
        return None
    return jtree, tfn()


def _same_leaves(jtree, ttree, jmesh, tmesh_):
    """Every ShapeDtypeStruct of ``jtree`` against the TensorSpec in the
    same place of ``ttree``: shape, dtype, spec, shard shape."""
    jl = jax.tree.leaves_with_path(jtree)
    tl = tleaves(ttree)
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        where = jax.tree_util.keystr(path)
        assert tuple(t.shape) == tuple(j.shape), where
        assert _dtype_name(t.dtype) == np.dtype(j.dtype).name, where
        if j.sharding is None:
            assert t.sharding is None, where
            continue
        assert tuple(t.sharding.spec) == tuple(j.sharding.spec), where
        assert t.sharding.shard_shape(t.shape) == \
            tuple(j.sharding.shard_shape(j.shape)), where
        assert t.sharding.num_devices == j.sharding.num_devices, where


@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_equal_reference(mesh_name, switch):
    jm, tm = _meshes(mesh_name)
    jr, tr = _rules(mesh_name, switch)
    for arch, red in CONFIGS:
        jc, tc = _cfgs(arch, red)
        jdefs, tdefs = jmodel.model_defs(jc), tmodel.model_defs(tc)
        js = _flat(jparams.param_specs(jdefs, jm, jr))
        ts = _flat(tparams.param_specs(tdefs, tm, tr))
        assert js.keys() == ts.keys(), arch
        td = _flat(tdefs)
        for k, spec in js.items():
            assert isinstance(ts[k], tshd.P)
            assert tuple(ts[k]) == tuple(spec), (arch, red, k)
            shape = td[k].shape
            pair = _both(lambda: JNamed(jm, spec),
                         lambda: tparams.param_shardings(
                             {"w": td[k]}, tm, tr)["w"])
            if pair is not None:
                assert pair[1].shard_shape(shape) == \
                    tuple(pair[0].shard_shape(shape)), (arch, k)
        # the abstract params carry the same specs, in the config's dtype
        # (or both refuse the tree: experts and FSDP both on data)
        pair = _both(lambda: jspecs.params_abstract(jc, jm, jr),
                     lambda: tspecs.params_abstract(tc, tm, tr))
        if pair is None:
            assert switch == "expert_data"
            continue
        _same_leaves(*pair, jm, tm)


@pytest.mark.parametrize("switch", ["default", "seq_shard"])
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_equal_reference(mesh_name, shape_name,
                                               switch):
    jm, tm = _meshes(mesh_name)
    jr, tr = _rules(mesh_name, switch)
    if shape_name == "long_500k":       # as the dry-run sets it
        jr["act_cache_seq"] = tr["act_cache_seq"] = "data"
    held = 0
    for arch, red in CONFIGS:
        jc, tc = _cfgs(arch, red)
        pair = _both(lambda: jspecs.batch_specs(jc, shape_name, jm, jr),
                     lambda: tspecs.batch_specs(tc, shape_name, tm, tr))
        if pair is None:            # seq_shard puts batch and seq on data
            assert switch == "seq_shard"
            continue
        jb, tb = pair
        assert sorted(jb) == sorted(tb), arch
        _same_leaves(jb, tb, jm, tm)
        held += 1
        if SHAPES[shape_name]["kind"] == "decode":
            assert len(tleaves(tb["caches"])) > 0
            # a cache of another batch and length, its ring sizes included
            _same_leaves(
                jmodel.cache_specs(jc, 3, 96, jm, jr),
                tmodel.cache_specs(tc, 3, 96, tm, tr), jm, tm)
    assert held > 0 or (switch == "seq_shard"
                        and SHAPES[shape_name]["kind"] != "decode")


@pytest.mark.parametrize("opt", ["adamw", "adamw_bf16", "adafactor"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_opt_state_specs_equal_reference(mesh_name, opt):
    jm, tm = _meshes(mesh_name)
    jr, tr = _rules(mesh_name, "default")
    name = "adafactor" if opt == "adafactor" else "adamw"
    sd = "bfloat16" if opt == "adamw_bf16" else None
    jt = JTrainConfig(optimizer=name, adamw=JAdamWConfig(state_dtype=sd))
    tt = TTrainConfig(optimizer=name, adamw=TAdamWConfig(state_dtype=sd))
    for arch, red in CONFIGS:
        jc, tc = _cfgs(arch, red)
        jo = jspecs.opt_state_abstract(jspecs.params_abstract(jc, jm, jr),
                                       jt, jm)
        to = tspecs.opt_state_abstract(tspecs.params_abstract(tc, tm, tr),
                                       tt, tm)
        assert type(to).__name__ == type(jo).__name__
        _same_leaves(jo, to, jm, tm)


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_sharding.py:16-41) on the port
# ---------------------------------------------------------------------------

def test_spec_divisibility_guard():
    mesh = tshd.AbstractMesh((16, 16), ("data", "model"))
    rules = tshd.default_rules()
    # 9 heads don't divide 16 -> replicated; 32 do -> sharded
    assert tshd.spec_for((576, 9, 64), ("fsdp", "tp", None), mesh, rules) \
        == tshd.P("data", None, None)
    assert tshd.spec_for((5120, 32, 160), ("fsdp", "tp", None), mesh,
                         rules) == tshd.P("data", "model", None)


def test_multi_pod_batch_axes():
    mesh = tshd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    rules = tshd.default_rules(multi_pod=True)
    assert tshd.spec_for((256, 4096), ("act_batch", "act_seq"), mesh,
                         rules) == tshd.P(("pod", "data"), None)
    # batch=1 cannot shard
    assert tshd.spec_for((1, 4096), ("act_batch", "act_seq"), mesh,
                         rules) == tshd.P(None, None)


@pytest.mark.parametrize("where", ["no_mesh", "abstract_mesh"])
def test_constrain_noop_outside_mesh(where):
    x = torch.arange(16.0).reshape(4, 4)
    if where == "no_mesh":
        y = tshd.constrain(x, "act_batch", None)
    else:
        with tshd.use_sharding(tmesh.make_test_mesh(), tshd.default_rules()):
            y = tshd.constrain(x, "act_batch", None)
    assert y is x


def test_spec_for_without_rules_is_replicated():
    mesh = tmesh.make_production_mesh()
    assert tshd.spec_for((8, 8), ("act_batch", None), mesh, None) == tshd.P()
    with tshd.use_sharding(mesh, tshd.default_rules()):
        # the active mesh and rules are read when none are passed
        assert tshd.spec_for((32, 8), ("act_batch", None)) == \
            tshd.P("data", None)
    assert tshd.active_mesh() is None and tshd.active_rules() is None
    with pytest.raises(ValueError):
        tshd.spec_for((8,), ("act_batch", None), mesh, tshd.default_rules())


def test_production_meshes_equal_reference():
    from repro.launch import mesh as jmesh_mod
    for mp in (False, True):
        m = tmesh.make_production_mesh(multi_pod=mp)
        assert isinstance(m, tshd.AbstractMesh)
        assert m.size == tmesh.device_count_required(mp) == \
            jmesh_mod.device_count_required(mp)
        assert tuple(m.shape.items()) == (
            (("pod", 2),) if mp else ()) + (("data", 16), ("model", 16))
    assert tmesh.make_test_mesh().shape == {"data": 2, "model": 4}


def test_tensor_spec_meta_allocates_nothing():
    jm, tm = _meshes("16x16")
    _, tr = _rules("16x16", "default")
    abs_ = tspecs.params_abstract(treg.get_config("kimi-k2-1t-a32b"), tm, tr)
    leaf = tleaves(abs_)[0]
    t = leaf.meta()
    assert t.device.type == "meta" and tuple(t.shape) == leaf.shape
    assert t.dtype == leaf.dtype
