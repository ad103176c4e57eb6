"""The deviation measure's lag sums in the reference's order (ROADMAP C2).

The reference takes ``jnp.mean`` over a row of L lag terms
(``repro.core.measures``, vmapped over candidates).  Past 32 lags XLA's
CPU row-reduce sums such a row in blocks (``kernels.ref.row_sum_xla``),
and the port's ranking keys (``ref.measure_rows``, which the ranking
kernels repeat through ``rn::row_sum``) take the same order:

(a) ``ref.measure_rows`` equals ``jax.vmap(get_measure(m))`` bit for bit at
    L = 12, 32, 33, 48 and 365, in float32 and float64, for mae, rmse and
    cheb (a chain from the first lag parts from it at L >= 33);
(b) ``compress_rounds`` on a 2,048-point uk_elec stand-in at L = 48, ranks
    ``window`` and ``single``: every carry field equal round by round, and
    ``kept``, iterations and deviation end to end;
(c) ``select="scan"`` at L = 48 end to end;
(d) the sequential mode at L = 48, held to the default compilation (the
    strict flags crash XLA there, C10): kept mask and iterations equal,
    deviation within 1e-12;
(e) a Python model of ``rn::row_sum``'s walk over the block bounds equals
    ``row_sum_xla`` for every L up to 1,100 and at two levels of blocks.

(a)-(c) hold the JAX package compiled without XLA's float rewrites
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``,
C1), in a subprocess; (d) the default compilation, in another.
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
import torch.nn.functional as F

from repro.core import cameo as jc
from repro.core import measures as jm
from repro_torch import convert
from repro_torch.core import cameo as tc
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import ref as t_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
LAGS = (12, 32, 33, 48, 365)
DTYPES = ("float32", "float64")
MEASURES = ("mae", "rmse", "cheb")
N_ROWS = 4096
N_UK = 2048
UK = dict(eps=1e-2, lags=48)
RANKS = ("window", "single")
FIELDS = ("xr", "alive", "prev", "nxt", "y", "tbl", "alpha", "dev", "rounds",
          "done", "blocked", "retried", "saw_c")


def row_sum_walk(terms):
    """``rn::row_sum`` in Python: the block bounds walked as the kernels
    walk them, each block of terms (a sequence of equal-shaped tensors)
    chained from +0, the block sums chained within blocks of theirs
    (``ref.xla_row_blocks``' sizes at both levels), and those chained."""
    def block(n, b):
        if n <= 32:
            return n
        pad = -n % 32
        lo, nw = pad // 2, (n + pad) // 32
        return 32 - lo if b == 0 else 32 - (pad - lo) if b == nw - 1 else 32

    zero = torch.zeros_like(terms[0])

    def chain(lo, hi):
        acc = zero
        for c in range(lo, hi):
            acc = acc + terms[c]
        return acc

    L = len(terms)
    if L <= 32:
        return chain(0, L)
    n1 = -(-L // 32)
    total, b0, b1, i = zero, 0, 0, 0
    while b0 < n1:
        s1, end = zero, b0 + block(n1, b1)
        while b0 < end:
            m = block(L, b0)
            s1 = s1 + chain(i, i + m)
            i, b0 = i + m, b0 + 1
        total, b1 = total + s1, b1 + 1
    return total


def _rows(L, dtype):
    """``N_ROWS`` ACF-like rows near ``p0``, their distances spread over
    five decades, as a round's candidates are."""
    rng = np.random.default_rng(L)
    p0 = np.tanh(rng.standard_normal(L))
    scale = 10.0 ** rng.uniform(-6, -1, (N_ROWS, 1))
    rows = p0 + scale * rng.standard_normal((N_ROWS, L))
    return rows.astype(dtype), p0.astype(dtype)


def _uk(n=N_UK):
    return make_dataset("uk_elec", seed=0, length=n)


def _jcfg(**kw):
    return jc.CameoConfig(**{**UK, **kw})


def _bits_equal(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


# ---------------------------------------------------------------------------
# the JAX side, in subprocesses
# ---------------------------------------------------------------------------

def _strict_main(out):
    """Strict compilation: the measures (a), the stepped rounds runs (b)
    and the scan (c)."""
    res = {}
    for L in LAGS:
        for dtype in DTYPES:
            rows, p0 = _rows(L, dtype)
            for m in MEASURES:
                fn = jax.jit(jax.vmap(jm.get_measure(m), in_axes=(0, None)))
                res[f"measure/{L}/{dtype}/{m}"] = np.asarray(
                    fn(jnp.asarray(rows), jnp.asarray(p0)))
    x = _uk()
    for rank in RANKS:
        cfg = _jcfg(rank=rank)
        nb = jc._round_bucket(N_UK, cfg)
        min_alive, eps = jc._halting_params(N_UK, cfg)
        nv = jnp.asarray(N_UK, jnp.int32)
        carry, p0 = jax.jit(lambda xp, nv: jc._rounds_init(xp, nv, cfg))(
            jnp.pad(jnp.asarray(x), (0, nb - N_UK)), nv)
        step = jax.jit(lambda c, p0: jc._rounds_chunk(
            c, nv, jnp.asarray(min_alive, jnp.int32), jnp.asarray(eps), p0,
            cfg=cfg, budget=1))
        k, live = 0, True
        while live:
            for f, v in zip(FIELDS, carry):
                res[f"rounds/{rank}/{k}/{f}"] = np.asarray(v)
            carry, live = step(carry, p0)
            k += 1
        for f, v in zip(FIELDS, carry):
            res[f"rounds/{rank}/{k}/{f}"] = np.asarray(v)
        res[f"rounds/{rank}/count"] = np.asarray(k)
        r = jc.compress_rounds(jnp.asarray(x), cfg)
        for f in ("kept", "iters", "deviation"):
            res[f"e2e/{rank}/{f}"] = np.asarray(getattr(r, f))
    r = jc.compress_rounds(jnp.asarray(x), _jcfg(select="scan"))
    for f in ("kept", "iters", "deviation"):
        res[f"e2e/scan/{f}"] = np.asarray(getattr(r, f))
    np.savez(out, **res)


def _default_main(out):
    """Default compilation: the sequential run (d)."""
    r = jc.compress(jnp.asarray(_uk()), _jcfg(mode="sequential"))
    np.savez(out, **{f: np.asarray(getattr(r, f))
                     for f in ("kept", "iters", "deviation")})


class _Reference:
    """A JAX subprocess started when the module's first test asks, read
    when a test needs its results."""

    def __init__(self, kind, out):
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        env.pop("XLA_FLAGS", None)
        if kind == "strict":
            env["XLA_FLAGS"] = STRICT_XLA_FLAGS
        self.out = out
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), f"--{kind}", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
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
    tmp = tmp_path_factory.mktemp("jax_lag_order")
    out = {kind: _Reference(kind, str(tmp / f"{kind}.npz"))
           for kind in ("strict", "default")}
    yield out
    for r in out.values():
        r.close()


# ---------------------------------------------------------------------------
# (a) the measures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", LAGS)
def test_measure_rows_equal_vmapped_mean(refs, L, dtype, measure):
    rows, p0 = _rows(L, dtype)
    got = t_ref.measure_rows(torch.from_numpy(rows), torch.from_numpy(p0),
                             measure)
    want = refs["strict"]()[f"measure/{L}/{dtype}/{measure}"]
    assert _bits_equal(got.numpy(), want), int(
        np.sum(got.numpy() != want))


def test_lag_chain_parts_past_32_lags():
    """The chain from the first lag is the block order up to 32 lags and
    not past them (why (a) holds the blocks)."""
    for L, differs in ((32, False), (33, True), (48, True), (365, True)):
        rows, p0 = _rows(L, "float32")
        terms = torch.abs(torch.from_numpy(rows - p0))
        chain = t_ref.chain_sum(terms)
        blocks = t_ref.row_sum_xla(terms)
        assert bool(torch.any(chain != blocks)) == differs, L


# ---------------------------------------------------------------------------
# (b) rounds, stepped; (c) the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", RANKS)
def test_rounds_carry_equal_every_round(refs, rank):
    jcfg = _jcfg(rank=rank)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    nb = tc._round_bucket(N_UK, cfg)
    min_alive, eps = tc._halting_params(N_UK, cfg)
    nv = torch.tensor([N_UK], dtype=torch.int32)
    xp = F.pad(torch.from_numpy(_uk()), (0, nb - N_UK))[None]
    carry, p0 = tc._rounds_init(xp, nv, cfg)
    probe, body = tc._round_fns(
        cfg, nb, nv, torch.tensor([min_alive], dtype=torch.int32),
        torch.tensor([eps], dtype=torch.float64), p0)
    want = refs["strict"]()
    count = int(want[f"rounds/{rank}/count"])
    assert count > 20
    k, live = 0, True
    while live:
        got = convert.carry_to_numpy(carry)
        bad = [f for f, g in zip(FIELDS, got)
               if not _bits_equal(g, want[f"rounds/{rank}/{k}/{f}"])]
        assert not bad, (k, bad)
        carry, live = tc._round_step(carry, probe, body)
        k += live
    assert k == count
    res = tc.compress_rounds(_uk(), cfg, device="cpu")
    for f in ("kept", "iters", "deviation"):
        assert _bits_equal(getattr(res, f).numpy(),
                           want[f"e2e/{rank}/{f}"]), f


def test_scan_end_to_end(refs):
    cfg = convert.config_from_dict(dataclasses.asdict(_jcfg(select="scan")))
    res = tc.compress(_uk(), cfg, device="cpu")
    want = refs["strict"]()
    for f in ("kept", "iters", "deviation"):
        assert _bits_equal(getattr(res, f).numpy(), want[f"e2e/scan/{f}"]), f


# ---------------------------------------------------------------------------
# (d) the sequential mode, against the default compilation
# ---------------------------------------------------------------------------

def test_sequential_end_to_end(refs):
    cfg = convert.config_from_dict(
        dataclasses.asdict(_jcfg(mode="sequential")))
    res = tc.compress(_uk(), cfg, device="cpu")
    want = refs["default"]()
    np.testing.assert_array_equal(res.kept.numpy(), want["kept"])
    assert int(res.iters) == int(want["iters"])
    assert abs(float(res.deviation) - float(want["deviation"])) <= 1e-12


# ---------------------------------------------------------------------------
# (e) the kernels' walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_sum_walk_is_row_sum_xla(dtype):
    """``rn::row_sum``'s walk, modelled step for step, equals
    ``row_sum_xla`` at every L up to 1,100 and at two levels of blocks
    (past 1,024 lags), on 16 rows of terms spread over eight decades."""
    rng = np.random.default_rng(5)
    for L in list(range(1, 1101)) + [1025, 1057, 2080, 5000]:
        v = torch.from_numpy(10.0 ** rng.uniform(-8, 0, (16, L))).to(dtype)
        got = row_sum_walk(list(v.T))
        assert torch.equal(got, t_ref.row_sum_xla(v)), L


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    if sys.argv[1] == "--strict":
        _strict_main(sys.argv[2])
    elif sys.argv[1] == "--default":
        _default_main(sys.argv[2])
