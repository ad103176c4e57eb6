"""The port's dry-run (``repro_torch.launch.dryrun``) and collective record
(``launch.collectives``) against the JAX package's ``launch.dryrun`` and
``launch.hlo``, on the CPU.

``run_cell`` traces every ``cells(include_skipped=False)`` cell on the meta
device at its reduced config (a full-width trace of a ``prefill_32k`` cell
dispatches ~10^5-10^6 meta operations, minutes each on this host), and one
cell a family at full width: dense (qwen3-0.6b decode_32k), MoE
(qwen3-moe-235b-a22b decode_32k), Mamba (mamba2-2.7b long_500k), hybrid
(jamba-1.5-large-398b long_500k), vision (qwen2-vl-2b train_4k, the patch
embeds) and audio (musicgen-large train_4k), those also on the multi-pod
mesh.  The traces run in four spawned processes.  Each row's step kind and
output shapes are the cell's; its analytic terms equal the reference's
``launch.analytic`` with ``==``, its model flops the reference's
``active_param_count`` arithmetic, and its ``arg_bytes`` the reference's
``dryrun._arg_bytes`` of its own specs on the 512-device forced host
platform (a subprocess: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` on
import, which must not reach this process).  The launcher's
``--arch/--shape`` path writes its row under ``build/dryrun/``.
"""
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import analytic as ja
from repro.launch import hlo as jhlo
from repro_torch import sharding as shd
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import cells
from repro_torch.launch import collectives as tcoll
from repro_torch.launch import dryrun as tdry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL_CELLS = (("qwen3-0.6b", "decode_32k"),
              ("qwen3-moe-235b-a22b", "decode_32k"),
              ("mamba2-2.7b", "long_500k"),
              ("jamba-1.5-large-398b", "long_500k"),
              ("qwen2-vl-2b", "train_4k"),
              ("musicgen-large", "train_4k"))
CASES = [(a, s, True, False) for a, s, _ in cells(include_skipped=False)] \
    + [(a, s, False, mp) for a, s in FULL_CELLS for mp in (False, True)]
# the slowest traces first: the reduced Mamba chunk loops (16 tokens a
# chunk) at 32,768 and 4,096 tokens, then the full-width train cells
_COST = {"jamba-1.5-large-398b": 4, "mamba2-2.7b": 2}
_SHAPE_COST = {"prefill_32k": 2, "train_4k": 1}


def _trace(case):
    torch.set_num_threads(1)
    arch, shape, reduced, mp = case
    return tdry.run_cell(arch, shape, mp, save=False, reduced=reduced)


_JAX_ARG_BYTES = """
import json, sys
import repro.launch.dryrun as d     # sets XLA_FLAGS (512 host devices)
from repro import sharding as shd
from repro.configs.registry import get_config, get_reduced
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import (default_train_config, opt_state_abstract,
                                params_abstract)
from repro.configs.base import SHAPES
out = {}
for arch, shape, reduced, mp in json.loads(sys.argv[1]):
    cfg = get_reduced(arch) if reduced else get_config(arch)
    mesh = make_production_mesh(multi_pod=mp)
    rules = shd.default_rules(multi_pod=mp, fsdp=True)
    if shape == "long_500k":
        rules["act_cache_seq"] = "data"
    with shd.use_sharding(mesh, rules):
        params = params_abstract(cfg, mesh, rules)
        tree = params
        if SHAPES[shape]["kind"] == "train":
            tree = (params, opt_state_abstract(
                params, default_train_config(cfg), mesh))
        out["|".join(map(str, (arch, shape, reduced, mp)))] = \\
            d._arg_bytes(tree, mesh)
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def rows():
    """Every case's row (four spawned tracing processes) and the
    reference's argument bytes (a JAX subprocess), started together."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_ARG_BYTES, json.dumps(CASES)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    order = sorted(CASES, key=lambda c: -(_COST.get(c[0], 0) * c[2] + 1)
                   * _SHAPE_COST.get(c[1], 0))
    try:
        with concurrent.futures.ProcessPoolExecutor(
                4, mp_context=multiprocessing.get_context("spawn")) as pool:
            got = dict(zip(order, pool.map(_trace, order)))
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT:")][0]
    ref = json.loads(line[len("RESULT:"):])
    return got, ref


def _id(case):
    arch, shape, reduced, mp = case
    return f"{arch}-{shape}-{'reduced' if reduced else 'full'}" + \
        ("-2x16x16" if mp else "")


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_run_cell_traces_and_matches_reference(rows, case):
    got, ref = rows
    arch, shape, reduced, mp = case
    r = got[case]
    cfg = (jreg.get_reduced if reduced else jreg.get_config)(arch)
    info = SHAPES[shape]
    kind = info["kind"]
    B, S = info["global_batch"], info["seq_len"]
    chips = 512 if mp else 256
    assert r["step"] == {"train": "train_step", "prefill": "prefill_step",
                         "decode": "serve_step"}[kind]
    assert r["chips"] == chips and r["trace"] == "meta"
    if kind == "train":
        assert r["out_shapes"]["loss"] == []
    elif kind == "prefill":
        assert r["out_shapes"]["logits"] == [B, 1, cfg.vocab]
        assert r["out_shapes"]["caches"]
    else:
        assert r["out_shapes"]["logits"] == [B, 1, cfg.vocab]
    pd = r["per_device"]
    assert pd["hlo_flops"] == ja.step_flops(cfg, shape)["flops_global"] \
        / chips
    assert pd["hlo_bytes"] == ja.step_hbm_bytes(
        cfg, shape, chips, model_par=16)["hbm_bytes_per_device"]
    assert pd["arg_bytes"] == ref["|".join(map(str, case))]
    tokens = B * S if kind != "decode" else B
    mult = 6.0 if kind == "train" else 2.0
    rf = r["roofline"]
    assert rf["model_flops_global"] == \
        mult * jreg.active_param_count(cfg) * tokens
    assert rf["useful_flops_ratio"] == \
        rf["model_flops_per_device"] / pd["hlo_flops"]
    assert rf["compute_s"] == pd["hlo_flops"] / tdry.HW["peak_flops"]
    assert rf["memory_s"] == pd["hlo_bytes"] / tdry.HW["hbm_bw"]
    assert rf["dominant"] == max(("compute_s", "memory_s"),
                                 key=lambda k: rf[k])
    assert rf["collective_s"] is None and rf["collective_reason"]
    assert r["memory_analysis"] is None and r["memory_analysis_reason"]


def test_launcher_writes_under_build_dryrun(capsys):
    r = tdry.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                   "--tag", "launcher_test", "--set", "kv_prune=2",
                   "--rule", "fsdp=None"])
    path = os.path.join(ROOT, "build", "dryrun",
                        "smollm-135m_decode_32k_16x16__launcher_test.json")
    try:
        assert os.path.realpath(r["path"]) == os.path.realpath(path)
        with open(path) as f:
            saved = json.load(f)
        assert saved["variant"] == "launcher_test"
        assert saved["per_device"] == r["per_device"]
        assert "[dryrun] smollm-135m x decode_32k" in capsys.readouterr().out
    finally:
        if os.path.exists(path):
            os.remove(path)
    assert tdry.main(["--arch", "smollm-135m", "--shape", "long_500k"]) \
        is None
    assert "SKIP" in capsys.readouterr().out


def test_override_parsing_matches_reference():
    import importlib.util
    spec = importlib.util.find_spec("repro.launch.dryrun")
    src = open(spec.origin).read()
    ns = {}
    start = src.index("def _parse_override")
    exec(src[start:src.index("\n\n\n", start)], ns)   # no XLA_FLAGS here
    for kv in ("a=3", "b=0.5", "c=True", "d=None", "e=model", "f=1e-3"):
        assert tdry._parse_override(kv) == ns["_parse_override"](kv)


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all",
                                  "collective-permute"])
def test_collective_ring_model_equals_reference(kind):
    for nbytes in (4, 1_059_460, 123_456_789):
        for g in (1, 2, 4, 16, 256):
            want = jhlo.Collective(kind, nbytes, g, "c", 3)
            got = tcoll.Collective(kind, nbytes, g, "c", 3)
            assert got.wire_bytes == want.wire_bytes


def test_collective_summary_schema_and_recorder():
    recs = [tcoll.Collective("all-reduce", 1_059_460, 4, "dp_shardmap.step"),
            tcoll.Collective("all-gather", 64, 2, "sharding.gather_ranks", 5)]
    s = tcoll.collective_summary(recs)
    assert set(s) == {"per_device_wire_bytes", "by_kind_bytes", "op_counts",
                      "n_sites"}
    assert s["per_device_wire_bytes"] == 1_589_190 + 5 * 32
    assert s["op_counts"] == {"all-reduce": 1, "all-gather": 5}
    assert s["n_sites"] == 2
    assert tcoll.RECORDER is None
    with tcoll.record_collectives() as outer:
        tcoll.note("all-reduce", 8, 2, "x")
        with tcoll.record_collectives() as inner:
            tcoll.note("all-to-all", 8, 2, "y")
        tcoll.note("all-reduce", 8, 2, "x")
    assert [c.kind for c in outer] == ["all-reduce", "all-reduce"]
    assert [c.kind for c in inner] == ["all-to-all"]
    assert tcoll.RECORDER is None
    tcoll.note("all-reduce", 8, 2, "x")          # no recorder: dropped


def test_moe_a2a_refuses_abstract_mesh():
    from repro_torch.configs import registry as treg
    from repro_torch.configs.base import layer_ctx
    from repro_torch.models import moe_a2a
    cfg = treg.get_reduced("qwen3-moe-235b-a22b")
    ls = next(l for l in cfg.all_layers() if l.moe)
    with shd.use_sharding(shd.AbstractMesh((2, 2), ("data", "model")),
                          shd.default_rules()):
        with pytest.raises(ValueError, match="AbstractMesh"):
            moe_a2a.moe_apply({}, torch.zeros(1, 2, cfg.d_model),
                              layer_ctx(cfg, ls), impl="a2a")
