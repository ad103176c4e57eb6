"""The port's sums in the JAX reference's order (ROADMAP C2 and B5).

(a) the kappa-window sums: ``aggregate_series`` (sum and mean) and
    ``_x_to_y_delta`` add a window's points in XLA's row-reduce order
    (``kernels.ref.row_sum_xla``: up to 32 values left to right, longer rows
    in blocks of 32 whose first and last share the rest), bit-equal to
    ``jax.jit(lambda v: v.reshape(-1, k).sum(1))`` at the datasets' kappas
    and around the block boundaries, in float64 and float32, at 1, 3 and
    300 rows; the order holds in
    the reduce's real contexts (``_rounds_init``, the round body's delta,
    ``_column_deviation``'s eager mean), where XLA's default compilation
    multiplies by ``1/kappa`` and the port divides;
(b) the other sums and roots the Eq. 2/7 path shares with the reference:
    ``chain_sum`` (``torch.cumsum``'s CPU order, pinned here), ``sqrt_rn``
    (torch's vectorized CPU square root is not correctly rounded), the
    measures' means, and ``lag_dot``'s plain version;
(c) ROADMAP B5: msmape's two prefix sums and the scan's ``pred`` equal
    their ``jnp.cumsum`` in their jitted contexts (vmapped too) bit for bit;
(d) an aus_elec-shaped rounds run (kappa 48, L 7, the first 23,040 points)
    equal to the JAX package compiled without XLA's float rewrites (the
    compilation the port is held to, in a subprocess) bit for bit: kept
    mask, iterations, reconstruction and deviation;
(e) on a card only: the card's kappa sums, roots, msmape and ``pred``
    equal the CPU's bits.
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

from repro.core import cameo as jc
from repro.core import measures as jm
from repro.core.acf import aggregate_series as j_aggregate
from repro_torch import convert
from repro_torch.core import cameo as tc
from repro_torch.core import measures as tm
from repro_torch.core.acf import aggregate_series as t_aggregate
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.lag_dot import lag_dot_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
KAPPAS = (2, 7, 24, 32, 33, 40, 48, 60, 64, 65, 70, 96, 120)
AUS = dict(eps=1e-2, lags=7, kappa=48)
AUS_N = 48 * 480
MEASURES = ("mae", "rmse", "nrmse", "mape", "msmape")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(rows, k, dtype, seed=0):
    rng = np.random.default_rng(seed + k)
    x = rng.standard_normal((rows, k)) * 10 ** rng.uniform(-3, 3, (rows, k))
    return x.astype(dtype).reshape(-1)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.atleast_1d(a).view(np.uint8), np.atleast_1d(b).view(np.uint8))


@pytest.mark.parametrize("k", KAPPAS)
def test_kappa_sum_matches_xla_row_reduce(k):
    reduce = jax.jit(lambda v: v.reshape(-1, k).sum(1))
    for dtype in (np.float64, np.float32):
        for rows in (1, 3, 300):
            x = _rows(rows, k, dtype)
            want = np.asarray(reduce(jnp.asarray(x)))
            got = t_aggregate(torch.from_numpy(x), k, "sum").numpy()
            assert _bits_equal(got, want), (dtype, rows)
            # the mean divides that sum by kappa exactly
            mean = t_aggregate(torch.from_numpy(x), k).numpy()
            assert _bits_equal(mean, (want / dtype(k)).astype(dtype))
    # lanes: [B, n] sums each row as alone
    x = _rows(6, k, np.float64).reshape(2, -1)
    got = t_aggregate(torch.from_numpy(x), k, "sum").numpy()
    for b in range(2):
        assert _bits_equal(got[b], np.asarray(reduce(jnp.asarray(x[b]))))


def test_row_blocks_rule():
    """The block sizes found by probing XLA's reduction tree."""
    blocks = t_ref.xla_row_blocks
    assert blocks(1) == [1] and blocks(32) == [32]
    assert blocks(33) == [17, 16] and blocks(48) == [24, 24]
    assert blocks(64) == [32, 32] and blocks(65) == [17, 32, 16]
    assert blocks(70) == [19, 32, 19] and blocks(96) == [32, 32, 32]
    assert blocks(120) == [28, 32, 32, 28]
    for k in range(1, 300):
        assert sum(blocks(k)) == k


@pytest.mark.parametrize("k", (48, 60, 120))
def test_kappa_sums_in_their_real_contexts(k):
    """XLA keeps the order where the reduce is fused: the rounds init's
    target series, the round body's delta (vmapped over lanes) and the
    eager mean of ``_column_deviation`` equal the port's sum times
    ``1/kappa`` (the default compilation's rewrite of ``/ kappa``); the
    port divides."""
    n = k * 40
    x = make_dataset("aus_elec", seed=1, length=n)
    jcfg = jc.CameoConfig(eps=1e-2, lags=7, kappa=k)
    nb = jc._round_bucket(n, jcfg)
    xp = np.pad(x, (0, nb - n))
    carry, _ = jax.jit(lambda v: jc._rounds_init(
        v, jnp.asarray(n, jnp.int32), jcfg))(jnp.asarray(xp))
    s = t_aggregate(torch.from_numpy(xp), k, "sum").numpy()
    assert _bits_equal(np.asarray(carry[4]), s * (1.0 / k))
    assert _bits_equal(t_aggregate(torch.from_numpy(xp), k).numpy(), s / k)
    d = np.random.default_rng(k).standard_normal((3, nb))
    want = np.asarray(jax.jit(jax.vmap(
        lambda v: jc._x_to_y_delta(v, k, jnp.float64)))(jnp.asarray(d)))
    s = t_aggregate(torch.from_numpy(d), k, "sum").numpy()
    assert _bits_equal(want, s * (1.0 / k))
    got = tc._x_to_y_delta(torch.from_numpy(d), k).numpy()
    assert _bits_equal(got, s / k)
    eager = np.asarray(j_aggregate(jnp.asarray(x), k))
    assert _bits_equal(eager, t_aggregate(torch.from_numpy(x), k,
                                          "sum").numpy() * (1.0 / k))


def test_chain_sum_is_the_sequential_chain():
    """``chain_sum`` adds first to last from +0: ``torch.cumsum``'s CPU
    float64 order (the port relies on it) and the explicit adds agree."""
    rng = np.random.default_rng(3)
    for shape in ((7, 5000), (2, 3, 33), (1,), (4, 17)):
        x = rng.standard_normal(shape) * 10 ** rng.uniform(-6, 6, shape)
        want = np.add.accumulate(x, axis=-1)[..., -1] + 0.0
        got = t_ref.chain_sum(torch.from_numpy(x)).numpy()
        assert _bits_equal(got, want)
        f32 = x.astype(np.float32)
        want32 = np.add.accumulate(f32, axis=-1, dtype=np.float32)[..., -1]
        got32 = t_ref.chain_sum(torch.from_numpy(f32)).numpy()
        assert _bits_equal(got32, want32 + np.float32(0.0))
    zero = t_ref.chain_sum(-torch.zeros(5, dtype=torch.float64))
    assert not np.signbit(zero.item())


def test_sqrt_rn_is_correctly_rounded():
    rng = np.random.default_rng(4)
    for dtype in (np.float64, np.float32):
        x = rng.uniform(0, 1e6, 20000).astype(dtype)
        got = t_ref.sqrt_rn(torch.from_numpy(x)).numpy()
        assert _bits_equal(got, np.sqrt(x))
        assert _bits_equal(got, np.asarray(jnp.sqrt(jnp.asarray(x))))
    x = torch.tensor([4.0, 2.0], dtype=torch.float64, requires_grad=True)
    t_ref.sqrt_rn(x).sum().backward()
    assert torch.allclose(x.grad, 0.5 / torch.sqrt(x.detach()))


def test_lag_dot_plain_sums_left_to_right():
    """Each lag's products summed first to last, the order of the JAX
    reference's ``a @ shifted`` compiled op by op (held end to end in
    ``test_aus_elec_rounds_match_strict``), in the self, cross and halo
    forms."""
    rng = np.random.default_rng(5)
    a, b, halo = (rng.standard_normal(n) * 100 for n in (600, 600, 9))
    for bb, hh in ((None, None), (b, None), (None, halo)):
        base = a if bb is None else bb
        ext = np.concatenate([base, np.zeros(9) if hh is None else hh])
        prods = np.stack([a * ext[l:l + 600] for l in range(1, 10)], 1)
        want = np.add.accumulate(prods, axis=0)[-1]
        got = lag_dot_plain(torch.from_numpy(a),
                            None if bb is None else torch.from_numpy(bb),
                            None if hh is None else torch.from_numpy(hh),
                            L=9).numpy()
        assert _bits_equal(got, want)


@pytest.mark.parametrize("L", (7, 24, 48))
def test_msmape_sums_equal_jnp_cumsum(L):
    """ROADMAP B5: msmape's ``csum`` and ``cdev`` equal the reference's
    ``jnp.cumsum`` in its jitted body, one vector and vmapped rows."""
    def ref_sums(a):
        n = a.shape[0]
        idx = jnp.arange(1, n + 1, dtype=a.dtype)
        csum = jnp.cumsum(a)
        prev_mean = jnp.where(idx > 1, (csum - a) / jnp.maximum(idx - 1, 1),
                              0.0)
        dev = jnp.abs(a - prev_mean)
        return csum, dev, jnp.cumsum(dev)

    rng = np.random.default_rng(L)
    a = rng.standard_normal((64, L)) * 0.3
    want = jax.jit(jax.vmap(ref_sums))(jnp.asarray(a))
    idx = torch.arange(1, L + 1, dtype=torch.float64)
    got = tm._msmape_sums(torch.from_numpy(a), idx)
    for g, w in zip(got, want):
        assert _bits_equal(g.numpy(), np.asarray(w))
    one = jax.jit(ref_sums)(jnp.asarray(a[0]))
    for g, w in zip(tm._msmape_sums(torch.from_numpy(a[0]), idx), one):
        assert _bits_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", (17, 300, 4100))
def test_scan_pred_equals_jnp_cumsum(k):
    """ROADMAP B5: the scan's ``pred`` equals the reference's
    ``dev + jnp.cumsum(where(isfinite(gs), gs, 0))`` under ``vmap``, with
    the +inf tail of the sorted marginals."""
    rng = np.random.default_rng(k)
    gs = np.sort(rng.standard_normal((3, k)) * 1e-4, axis=1)
    gs[:, -k // 5:] = np.inf
    dev = rng.uniform(0, 1e-2, 3)
    want = jax.jit(jax.vmap(lambda d, g: d + jnp.cumsum(
        jnp.where(jnp.isfinite(g), g, jnp.asarray(0.0, g.dtype)))))(
        jnp.asarray(dev), jnp.asarray(gs))
    g = torch.from_numpy(gs)
    got = tc._scan_pred(torch.from_numpy(dev), g, torch.isfinite(g), "auto")
    assert _bits_equal(got.numpy(), np.asarray(want))


def _reference(out_path):
    """Strict-compiled JAX: the aus_elec-shaped rounds run and the
    measures on a fixed pair of ACF vectors."""
    x = make_dataset("aus_elec", seed=0, length=AUS_N)
    r = jc.compress_rounds(jnp.asarray(x), jc.CameoConfig(**AUS))
    out = {f"aus/{f}": np.asarray(getattr(r, f))
           for f in ("kept", "xr", "iters", "deviation", "stat_orig",
                     "stat_new")}
    a, b = _acf_pair()
    for name in MEASURES:
        out[f"measure/{name}"] = np.asarray(
            jax.jit(jm.get_measure(name))(jnp.asarray(a), jnp.asarray(b)))
    np.savez(out_path, **out)


def _acf_pair():
    rng = np.random.default_rng(11)
    a = np.tanh(rng.standard_normal(48))
    return a, a + 1e-3 * rng.standard_normal(48)


@pytest.fixture(scope="module")
def strict(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_strict_sums") / "strict.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _strict_result(strict):
    proc, out = strict
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_aus_elec_rounds_match_strict(strict):
    """ROADMAP C2 on the CPU: kappa 48, L 7, 480 target points (271
    rounds); every field of the result bit for bit."""
    x = make_dataset("aus_elec", seed=0, length=AUS_N)
    jcfg = jc.CameoConfig(**AUS)
    got = tc.compress_rounds(
        x, convert.config_from_dict(dataclasses.asdict(jcfg)), device="cpu")
    want = _strict_result(strict)
    for f in ("kept", "xr", "iters", "deviation", "stat_orig", "stat_new"):
        assert _bits_equal(getattr(got, f).numpy(), want[f"aus/{f}"]), f
    assert int(got.iters) > 200


@pytest.mark.parametrize("name", MEASURES)
def test_measures_match_strict(strict, name):
    """The measures' means (XLA's row-reduce order, exact division) and
    roots equal the strict-compiled reference's bits at L = 48."""
    a, b = _acf_pair()
    got = tm.get_measure(name)(torch.from_numpy(a), torch.from_numpy(b))
    assert _bits_equal(got.numpy(), _strict_result(strict)[f"measure/{name}"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_sums_equal_cpu_bits(cuda):
    """The card's kappa sums and means, square roots, msmape and ``pred``
    equal the CPU's bit for bit."""
    for k in KAPPAS:
        for dtype in (np.float64, np.float32):
            x = torch.from_numpy(_rows(300, k, dtype))
            for agg in ("sum", "mean"):
                assert torch.equal(t_aggregate(x.to(cuda), k, agg).cpu(),
                                   t_aggregate(x, k, agg)), (k, dtype, agg)
        d = torch.from_numpy(_rows(6, k, np.float64).reshape(2, -1))
        assert torch.equal(tc._x_to_y_delta(d.to(cuda), k).cpu(),
                           tc._x_to_y_delta(d, k))
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1e6, 100000))
    for t in (x, x.float()):
        assert torch.equal(t_ref.sqrt_rn(t.to(cuda)).cpu(), t_ref.sqrt_rn(t))
    a, b = (torch.from_numpy(v) for v in _acf_pair())
    for name in MEASURES:
        fn = tm.get_measure(name)
        assert torch.equal(fn(a.to(cuda), b.to(cuda)).cpu(), fn(a, b)), name
    gs = torch.from_numpy(np.sort(np.random.default_rng(1).standard_normal(
        (2, 5000)), axis=1))
    dev = torch.tensor([1e-3, 2e-3], dtype=torch.float64)
    assert torch.equal(
        tc._scan_pred(dev.to(cuda), gs.to(cuda), torch.isfinite(gs).to(cuda),
                      "auto").cpu(),
        tc._scan_pred(dev, gs, torch.isfinite(gs), "auto"))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        jax.config.update("jax_enable_x64", True)
        _reference(sys.argv[2])
