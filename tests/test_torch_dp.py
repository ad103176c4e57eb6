"""The port's explicit data-parallel step (``repro_torch.train.dp_shardmap``)
on four gloo ranks against the JAX package's ``build_dp_train_step`` on a
4-device forced host mesh (a JAX subprocess, as
``tests/test_dryrun_small.py:254-303`` runs it), on the CPU.

The reduced smollm-135m, float32, its weights drawn by the port from seed
0 and carried to both sides (``convert.params_from_numpy`` on the ranks), a
16 x 32 batch a step from a numpy seed (rank ``r`` takes rows ``4r`` to
``4r + 3``, the reference's ``P("data")``), ``peak_lr`` 1e-3, two steps
under each of ``none``, ``int8`` and ``topk`` 0.1.  Step 0 starts from the
same weights; step 1 from the reference's step-0 parameters, AdamW state
and residuals, carried across: rank ``r`` takes device ``r``'s residuals.
The reference returns its residuals under ``out_specs=P()`` with the
replication unchecked, so the returned array keeps each device's own
residuals in that device's buffer (read as one array it is device 0's),
and each device takes its own back in at the next step: per-rank
residuals, as the port keeps them (ROADMAP C23).

Held:
* the mean loss within 2e-5 relative, ``grad_norm`` within 1e-4;
* the reference's returned residuals read as one array are device 0's;
  device ``d``'s buffer is the closest of the four devices' own (computed
  leaf by leaf in the subprocess) to device ``d``'s, and rank ``d``'s
  residuals equal it within ``GRAD_TOL`` x the leaf's largest |g + r|
  wherever the two codecs decided alike;
* every rank's sent leaves against the reference's device's: ``none``
  within ``GRAD_TOL`` everywhere; ``int8`` and ``topk`` within
  ``GRAD_TOL`` where the decisions agree, and the entries that decided
  otherwise (a quantum of ``int8``'s rounding, a ``topk`` mask at its
  threshold: the two frameworks' gradients part by up to ~1e-5 of a
  leaf's largest |g|, ``tests/test_torch_train_grads.py``) counted and
  held to ``FLIP_LIMIT``;
* every parameter within ``STEP_TOL`` x the leaf's largest |value|,
  except where the reference's mean gradient is nonzero and below
  ``SIGN_FLOOR`` x its leaf's largest (AdamW moves those by ~lr x
  sign(g)) or a rank's codec decided otherwise: those within 2 lr + the
  tolerance (an entry no rank sent moves by weight decay alone, held
  strictly); the AdamW moments
  within ``STATE_TOL`` x the leaf's largest outside the same entries;
* all four ranks' parameters bit-equal after each step;
* the recorded all-reduce wire bytes equal the reference's
  ``collective_summary`` of its compiled step's HLO: 1,589,190 a device
  (264,864 float32 gradients and the loss in one all-reduce of 1,059,460
  bytes over 4 devices), and the same one all-reduce.

The sum over ranks is gloo's (a ring), not XLA's: the mean's last bits
may differ, inside the tolerances above.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import sharding as shd
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_numpy
from repro_torch.launch.collectives import (collective_summary,
                                            record_collectives)
from repro_torch.models.model import model_defs
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.optim.compress import CompressConfig, init_residuals
from repro_torch.train import dp_shardmap as dp
from repro_torch.train.step import TrainConfig
from repro_torch.tree import leaves, leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-135m"
W, B, S, LR, STEPS = 4, 16, 32, 1e-3, 2
CODECS = ("none", "int8", "topk")
RATIO = 0.1
GRAD_TOL = 5e-5
STEP_TOL = 1e-5
STATE_TOL = 1e-4
SIGN_FLOOR = 1e-3
# codec decisions that may differ a step, over all ranks and leaves (of
# 4 x 264,864 entries): a gradient entry within ~1e-5 of the leaf's
# largest |g| of a rounding boundary (int8) or of the k-th magnitude
# (topk).  First reading: int8 11 and 16 in steps 0 and 1, topk 2 and 0
FLIP_LIMIT = {"none": 0, "int8": 100, "topk": 20}
REF_WIRE_BYTES = 1_589_190


def _ccfg(codec):
    return CompressConfig(codec=codec, ratio=RATIO)


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _ref_tree(ref, prefix, fn=np.array):
    """The reference's leaves under ``prefix`` as a nested dict (each
    leaf through ``fn``)."""
    n = len(prefix)
    return _nest({k[n:]: fn(np.array(ref[k])) for k in ref.files
                  if k.startswith(prefix)})


_JAX_DP = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import functools
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_reduced
from repro.launch.hlo import collective_summary
from repro.optim.adamw import adamw_init
from repro.optim.compress import (CompressConfig, compress_with_feedback,
                                  init_residuals)
from repro.train.dp_shardmap import build_dp_train_step
from repro.train.step import TrainConfig, loss_fn

def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)

def flat(prefix, tree, out):
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + key(p)] = np.asarray(v)

def nest(z):
    tree = {{}}
    for k in z.files:
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {{}})
        node[parts[-1]] = jnp.asarray(z[k])
    return tree

cfg = get_reduced({arch!r})
tcfg = TrainConfig(peak_lr={lr!r})
mesh = jax.make_mesh((4,), ("data",))
params0 = nest(np.load({params!r}))
toks = np.load({tokens!r})
grad_fn = jax.jit(jax.value_and_grad(
    functools.partial(loss_fn, cfg=cfg, tcfg=tcfg), has_aux=True))
out = {{}}
for codec in {codecs!r}:
    ccfg = CompressConfig(codec=codec, ratio={ratio!r})
    step = build_dp_train_step(cfg, tcfg, mesh, ccfg)
    p, opt, res = params0, adamw_init(params0, tcfg.adamw), \\
        init_residuals(params0)
    res_dev = [res] * 4
    for i in range({steps}):
        batch = {{"tokens": jnp.asarray(toks[i], jnp.int32)}}
        pre = f"{{codec}}/s{{i}}/"
        # each device's own codec output, leaf by leaf (the shard_map body
        # for rows 4d..4d+3 from that device's residuals)
        p_one = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), p)
        for d in range(4):
            rows = {{"tokens": batch["tokens"][4 * d:4 * d + 4]}}
            _, g = grad_fn(p_one, batch=rows)
            sent, r_d = compress_with_feedback(g, res_dev[d], ccfg)
            flat(pre + f"sent{{d}}/", sent, out)
            flat(pre + f"res{{d}}/", r_d, out)
        if i == 0:
            hlo = step.lower(p, opt, res, batch,
                             jnp.asarray(0, jnp.int32)).compile().as_text()
            summ = collective_summary(hlo, 4)
            out[pre + "wire_bytes"] = np.asarray(
                summ["per_device_wire_bytes"])
            out[pre + "all_reduces"] = np.asarray(
                summ["op_counts"].get("all-reduce", 0))
        p, opt, res, m = step(p, opt, res, batch, jnp.asarray(i, jnp.int32))
        # out_specs=P() unchecked: each device's buffer keeps its own
        # residuals (and takes them back in at the next step)
        res_dev = [jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a.addressable_shards[d].data)),
            res) for d in range(4)]
        for d in range(4):
            flat(pre + f"res_dev{{d}}/", res_dev[d], out)
        flat(pre + "params/", p, out)
        flat(pre + "m/", opt.m, out)
        flat(pre + "v/", opt.v, out)
        out[pre + "opt_step"] = np.asarray(opt.step)
        flat(pre + "res/", res, out)
        out[pre + "loss"] = np.asarray(m["loss"])
        out[pre + "grad_norm"] = np.asarray(m["grad_norm"])
np.savez({out!r}, **out)
"""


def _dp_rank(rank, world, rdv, work):
    """One gloo rank: two steps a codec (the second from the reference's
    carried state), each rank's sent leaves, residuals and parameters, the
    recorded collectives; and ``sharding.constrain`` of a DTensor."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        mesh = shd.mesh_1d("cpu")
        cfg = treg.get_reduced(ARCH)
        tcfg = TrainConfig(peak_lr=LR)
        ref = np.load(os.path.join(work, "ref.npz"))
        init = dict(np.load(os.path.join(work, "params.npz")))
        toks = np.load(os.path.join(work, "tokens.npy"))
        out = {"mesh_shape": shd.mesh_shape(mesh)}
        sent_log = []
        inner = dp.compress_with_feedback

        def recording(g, r, ccfg):
            s, r_new = inner(g, r, ccfg)
            sent_log.append(s.detach().clone())
            return s, r_new

        dp.compress_with_feedback = recording
        for codec in CODECS:
            step = dp.build_dp_train_step(cfg, tcfg, mesh, _ccfg(codec))
            for i in range(STEPS):
                if i == 0:
                    p = params_from_numpy(_nest(init), cfg, "cpu")
                    opt = adamw_init(p, tcfg.adamw)
                    res = init_residuals(p)
                else:
                    pre = f"{codec}/s{i - 1}/"
                    p = params_from_numpy(_ref_tree(ref, pre + "params/"),
                                          cfg, "cpu")
                    opt = AdamWState(
                        m=_ref_tree(ref, pre + "m/", torch.from_numpy),
                        v=_ref_tree(ref, pre + "v/", torch.from_numpy),
                        step=torch.tensor(int(ref[pre + "opt_step"]),
                                          dtype=torch.int32))
                    res = _ref_tree(ref, pre + f"res_dev{rank}/",
                                    torch.from_numpy)
                p.requires_grad_(True)
                batch = dp.shard_batch({"tokens": torch.from_numpy(toks[i])},
                                       mesh)
                sent_log.clear()
                with record_collectives() as rec:
                    p, opt, res, m = step(p, opt, res, batch, i)
                pre = f"{codec}/s{i}/"
                out[pre + "summary"] = collective_summary(rec)
                out[pre + "loss"] = float(m["loss"])
                out[pre + "grad_norm"] = float(m["grad_norm"])
                out[pre + "params"] = _tflat(p)
                out[pre + "m"] = _tflat(opt.m)
                out[pre + "v"] = _tflat(opt.v)
                out[pre + "res"] = _tflat(res)
                out[pre + "sent"] = dict(zip(_tflat(res), (
                    s.numpy() for s in sent_log)))
        dp.compress_with_feedback = inner
        # constrain: a DTensor is redistributed to the rules' spec
        from torch.distributed.tensor import Replicate, distribute_tensor
        x = distribute_tensor(torch.arange(32.0).reshape(8, 4), mesh,
                              [Replicate()])
        with shd.use_sharding(mesh, shd.default_rules()):
            y = shd.constrain(x, "act_batch", None)
            spec = shd.spec_for((8, 4), ("act_batch", None))
        out["constrain"] = (y.to_local().numpy().copy(), str(y.placements),
                            tuple(spec),
                            shd.NamedSharding(mesh, spec).shard_shape((8, 4)))
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tflat(tree) -> dict:
    return {_key(p): v.detach().float().numpy().copy()
            for p, v in leaves_with_path(tree)}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("dp")))


def run_both(work: str):
    """The reference's subprocess, then the four gloo ranks (which carry
    its step-0 state into step 1); returns (reference arrays, the ranks'
    outputs)."""
    cfg = treg.get_reduced(ARCH)
    params = init_params(model_defs(cfg), 0, "cpu")
    np.savez(os.path.join(work, "params.npz"),
             **{_key(p): v.detach().numpy() for p, v in
                leaves_with_path(params)})
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (STEPS, B, S))
    np.save(os.path.join(work, "tokens.npy"), toks)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    code = _JAX_DP.format(arch=ARCH, lr=LR, params=os.path.join(
        work, "params.npz"), tokens=os.path.join(work, "tokens.npy"),
        codecs=CODECS, ratio=RATIO, steps=STEPS,
        out=os.path.join(work, "ref.npz"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    ctx = mp.spawn(_dp_rank, args=(W, os.path.join(work, "rdv"), work),
                   nprocs=W, join=False)
    try:
        while not ctx.join(timeout=600):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(W)]
    with np.load(os.path.join(work, "ref.npz")) as z:
        ref = {k: z[k] for k in z.files}
    return ref, ranks


def _ref(ref, prefix) -> dict:
    n = len(prefix)
    return {k[n:]: v.astype(np.float64) for k, v in ref.items()
            if k.startswith(prefix)}


def _scale(w) -> float:
    return max(float(np.max(np.abs(w))), 1e-30) if w.size else 1.0


def _decided_otherwise(codec, got, want):
    """Entries where the codec decided otherwise: a ``topk`` mask entry,
    or an ``int8`` value off by a quantum or more."""
    if codec == "topk":
        return (got != 0) != (want != 0)
    if codec == "int8":
        q = _scale(want) / 127.0
        return np.abs(got - want) > 0.5 * q
    return np.zeros(want.shape, bool)


def _flips(codec, ranks, ref, pre):
    """{leaf: bool mask of entries any rank decided otherwise} and the
    count over ranks."""
    out, n = {}, 0
    for r, rk in enumerate(ranks):
        want = _ref(ref, pre + f"sent{r}/")
        for k, w in want.items():
            f = _decided_otherwise(codec, rk[pre + "sent"][k], w)
            n += int(f.sum())
            out[k] = out.get(k, np.zeros(w.shape, bool)) | f
    return out, n


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("i", range(STEPS))
def test_dp_metrics_match_reference(dp_runs, codec, i):
    ref, ranks = dp_runs
    pre = f"{codec}/s{i}/"
    for rk in ranks:
        assert rk[pre + "loss"] == pytest.approx(float(ref[pre + "loss"]),
                                                 rel=2e-5)
        assert rk[pre + "grad_norm"] == pytest.approx(
            float(ref[pre + "grad_norm"]), rel=1e-4)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("i", range(STEPS))
def test_dp_sent_and_residuals_match_reference(dp_runs, codec, i):
    ref, ranks = dp_runs
    pre = f"{codec}/s{i}/"
    flips, n = _flips(codec, ranks, ref, pre)
    assert n <= FLIP_LIMIT[codec], n
    for r, rk in enumerate(ranks):
        for k, w in _ref(ref, pre + f"sent{r}/").items():
            d = np.abs(rk[pre + "sent"][k] - w)
            same = ~_decided_otherwise(codec, rk[pre + "sent"][k], w)
            assert float(np.max(d[same], initial=0.0)) <= \
                GRAD_TOL * _scale(w), (r, k)
    # the returned residuals read as one array are device 0's buffer; each
    # device's buffer is that device's own (the closest of the four
    # devices' residuals computed leaf by leaf) and equals its rank's
    returned = _ref(ref, pre + "res/")
    dev0 = _ref(ref, pre + "res_dev0/")
    assert all(np.array_equal(returned[k], dev0[k]) for k in returned)
    for d in range(W):
        buf = _ref(ref, pre + f"res_dev{d}/")
        dists = [max(float(np.max(np.abs(_ref(ref, pre + f"res{e}/")[k]
                                         - w), initial=0.0))
                     for k, w in buf.items()) for e in range(W)]
        if codec != "none":
            assert int(np.argmin(dists)) == d, dists
        sent_d = _ref(ref, pre + f"sent{d}/")
        for k, w in buf.items():
            diff = np.abs(ranks[d][pre + "res"][k] - w)
            same = ~_decided_otherwise(codec, ranks[d][pre + "sent"][k],
                                       sent_d[k])
            # the residual carries the gradient's error: its scale is the
            # leaf's largest |g + r|
            assert float(np.max(diff[same], initial=0.0)) <= \
                GRAD_TOL * _scale(sent_d[k] + w), (d, k)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("i", range(STEPS))
def test_dp_params_and_state_match_reference(dp_runs, codec, i):
    ref, ranks = dp_runs
    pre = f"{codec}/s{i}/"
    flips, _ = _flips(codec, ranks, ref, pre)
    mean_g = {k: sum(_ref(ref, pre + f"sent{d}/")[k] for d in range(W)) / W
              for k in flips}
    want = _ref(ref, pre + "params/")
    got = ranks[0][pre + "params"]
    assert set(got) == set(want)
    for k, w in want.items():
        d = np.abs(got[k] - w)
        tol = STEP_TOL * _scale(w)
        small = np.abs(mean_g[k]) <= SIGN_FLOOR * _scale(mean_g[k])
        loose = (small & (mean_g[k] != 0)) | flips[k]
        bad = (d > tol) & ~(loose & (d <= 2 * LR + tol))
        assert not bad.any(), (k, float(d.max()), tol, int(bad.sum()))
    for name in ("m", "v"):
        want = _ref(ref, pre + name + "/")
        got = ranks[0][pre + name]
        for k, w in want.items():
            d = np.abs(got[k] - w)[~flips[k]]
            assert float(np.max(d, initial=0.0)) <= \
                STATE_TOL * _scale(w), (name, k)


@pytest.mark.parametrize("codec", CODECS)
def test_dp_replicas_stay_bit_equal(dp_runs, codec):
    _, ranks = dp_runs
    for i in range(STEPS):
        pre = f"{codec}/s{i}/"
        for rk in ranks[1:]:
            for name in ("params", "m", "v"):
                for k, v in ranks[0][pre + name].items():
                    assert np.array_equal(rk[pre + name][k], v), (i, name, k)
            assert rk[pre + "loss"] == ranks[0][pre + "loss"]
            assert rk[pre + "grad_norm"] == ranks[0][pre + "grad_norm"]


@pytest.mark.parametrize("codec", CODECS)
def test_dp_all_reduce_wire_bytes_equal_reference_hlo(dp_runs, codec):
    ref, ranks = dp_runs
    pre = f"{codec}/s0/"
    assert float(ref[pre + "wire_bytes"]) == REF_WIRE_BYTES
    for rk in ranks:
        summ = rk[pre + "summary"]
        assert summ["per_device_wire_bytes"] == REF_WIRE_BYTES
        assert summ["by_kind_bytes"] == {"all-reduce": REF_WIRE_BYTES}
        assert summ["op_counts"] == {"all-reduce": int(ref[pre +
                                                           "all_reduces"])}
        assert summ["n_sites"] == 1


def test_dp_ranks_constrain_dtensor(dp_runs):
    _, ranks = dp_runs
    x = np.arange(32.0).reshape(8, 4)
    for r, rk in enumerate(ranks):
        assert rk["mesh_shape"] == {"data": W}
        local, placements, spec, shard = rk["constrain"]
        assert spec == ("data", None) and shard == (2, 4)
        assert "Shard(dim=0)" in placements
        np.testing.assert_array_equal(local, x[2 * r:2 * r + 2])


def test_dp_backend_check():
    dp.check_backend("gloo", torch.device("cpu"))
    dp.check_backend("nccl", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="nccl group"):
        dp.check_backend("gloo", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="gloo group"):
        dp.check_backend("nccl", torch.device("cpu"))


def test_shard_batch_takes_the_ranks_rows():
    class _Mesh:            # what shard_batch reads of a DeviceMesh
        mesh_dim_names = ("data",)

        def __init__(self, r):
            self.r = r

        def get_local_rank(self, axis):
            return self.r

        def size(self, i):
            return W

    t = torch.arange(16 * 3).reshape(16, 3)
    for r in range(W):
        got = dp.shard_batch({"tokens": t}, _Mesh(r))["tokens"]
        assert torch.equal(got, t[4 * r:4 * r + 4])
    with pytest.raises(ValueError):
        dp.shard_batch({"tokens": t[:6]}, _Mesh(0))


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_gpu_dp_step_refuses_mismatched_backend(tmp_path):
    """On a card: the step raises for CPU tensors under an NCCL group and
    for card tensors under gloo (world size 1)."""
    for backend, device in (("nccl", "cpu"), ("gloo", "cuda")):
        dist.init_process_group(backend, init_method=f"file://{tmp_path}/"
                                f"{backend}", world_size=1, rank=0)
        try:
            mesh = shd.mesh_1d("cuda" if backend == "nccl" else "cpu")
            cfg = treg.get_reduced(ARCH)
            tcfg = TrainConfig(peak_lr=LR)
            step = dp.build_dp_train_step(cfg, tcfg, mesh, _ccfg("none"))
            p = init_params(model_defs(cfg), 0, device)
            p.requires_grad_(True)
            batch = {"tokens": torch.zeros((2, 8), dtype=torch.long,
                                           device=device)}
            with pytest.raises(ValueError, match="group"):
                step(p, adamw_init(p, tcfg.adamw), init_residuals(p), batch)
        finally:
            dist.destroy_process_group()


def test_chip_smoke_dp_rehearsal():
    """chip_smoke.py's data-parallel phase at a tiny size on the CPU (gloo
    at world size 1, the reduced musicgen config): the first step's
    error-feedback holds on every leaf, finite losses, the recorded
    all-reduce bytes (4 a parameter and the loss), and codec "none"
    bit-equal to the plain update."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = treg.get_reduced("musicgen-large")
        windows = np.random.default_rng(5).integers(0, cfg.vocab, (12, 32))
        lines = []
        out = chip_smoke.run_training_dp(
            "cpu", windows, sizes=dict(reduced=True, B=4, dp_steps=2),
            log=lines.append)
    finally:
        torch.set_num_threads(threads)
    topk, none = out["rows"]
    n = sum(int(np.prod(p.shape)) for p in leaves(
        init_params(model_defs(cfg), 0, "cpu")))
    assert topk["params"] == n and topk["world_size"] == 1
    assert topk["backend"] == "gloo" and topk["codec"] == "topk"
    assert len(topk["losses"]) == 3 and all(np.isfinite(topk["losses"]))
    assert topk["all_reduce_bytes"] == 4 * n + 4
    assert topk["all_reduces"] >= 1
    assert topk["leaves_held"] == len(leaves(init_params(
        model_defs(cfg), 0, "cpu")))
    assert topk["kept_share_min"] >= 0.05 * 0.9
    assert topk["S"] == 32 and topk["tokens_per_s"] > 0
    assert none["leaves_bit_equal"] and none["leaves"] > 0
    assert [ln.split()[0] for ln in lines] == ["dp", "dp"]
    assert not dist.is_initialized()
