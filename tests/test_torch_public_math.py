"""Public functions of the reference's series math that the port's files
of the same name carry too (``core.acf.lags_arange``,
``core.acf.acf_stationary``, ``core.aggregates.acf_after_single_delta``,
``kernels.ops.acf_impact``, ``kernels.fused_round.window_rows``), held to
strict-compiled JAX (``--xla_disable_hlo_passes=algsimp
--xla_backend_optimization_level=0``, ROADMAP C1) in a subprocess, on the
reference's own test inputs (``tests/test_acf.py``, ``tests/test_kernels.py``
and ``tests/test_contractions.py`` shapes).

Every output is held bit for bit.  The dispatches take the plain versions here (CPU tensors); on the card
``chip_smoke.py``'s phase 3 holds each to the kernel wrapper it calls.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import acf as t_acf
from repro_torch.core import aggregates as t_agg
from repro_torch.kernels import fused_round as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
LAGS = (1, 7, 48, 365)
STATIONARY = ((4096, 8, 1), (300, 10, 3), (1000, 48, 5))
IMPACT = ((256, 4), (1000, 24), (4096, 48), (513, 7), (2048, 1))
DTYPES = ("float32", "float64")
MEASURES = ("mae", "rmse", "cheb")
WINDOW_L = (4, 12)


def _series(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (np.sin(2 * np.pi * t / 24) + 0.5 * np.sin(2 * np.pi * t / 7)
            + 0.2 * rng.standard_normal(n))


def _impact_inputs(n, L, dtype, seed=0):
    """``tests/test_kernels.py``'s ``_setup``: (y, dval)."""
    rng = np.random.default_rng(seed)
    y = (np.sin(2 * np.pi * np.arange(n) / 24)
         + 0.2 * rng.standard_normal(n)).astype(dtype)
    dval = (0.1 * rng.standard_normal(n)).astype(dtype)
    return y, dval


def _window_inputs(L):
    """``tests/test_contractions.py``'s window_rows case."""
    rng = np.random.default_rng(3)
    nyb, ny, K, Wy = 128, 120, 7, 16
    y = np.zeros(nyb)
    y[:ny] = rng.standard_normal(ny)
    dyws = 0.1 * rng.standard_normal((K, Wy))
    starts = rng.integers(0, ny - Wy, size=K).astype(np.int32)
    return y, dyws, starts, ny


def _reference(out_path):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from repro.core import acf as j_acf
    from repro.core import aggregates as j_agg
    from repro.kernels import fused_round as j_fused
    from repro.kernels import ops as j_ops
    from repro.kernels import ref as j_ref

    out = {}
    for L in LAGS:
        for dt in DTYPES:
            out[f"lags/{L}/{dt}"] = np.asarray(j_acf.lags_arange(L, dt))
    for n, L, seed in STATIONARY:
        out[f"stationary/{n}/{L}"] = np.asarray(
            j_acf.acf_stationary(jnp.asarray(_series(n, seed)), L))
    x = jnp.asarray(_series(128, 9))
    agg = j_acf.extract_aggregates(x, 6)
    out["single/table"] = np.asarray(jnp.stack(list(agg)))
    out["single/rows"] = np.asarray(jax.jit(j_agg.acf_after_single_delta)(
        agg, x, jnp.asarray([0, 1, 63, 126, 127], jnp.int32),
        jnp.asarray([0.5, -1.0, 2.0, 0.1, -0.3])))
    for n, L in IMPACT:
        for dt in DTYPES:
            y, dval = _impact_inputs(n, L, dt)
            jagg = j_acf.extract_aggregates(jnp.asarray(y), L)
            tab = j_ops.agg_to_table(jagg).astype(dt)
            p0 = j_acf.acf_from_aggregates(jagg, n).astype(dt)
            key = f"impact/{n}/{L}/{dt}"
            out[key + "/table"], out[key + "/p0"] = np.asarray(tab), \
                np.asarray(p0)
            for m in MEASURES:
                out[f"{key}/{m}"] = np.asarray(jax.jit(
                    lambda *a, m=m: j_ops.acf_impact(
                        *a, measure=m, backend="reference"))(
                    jnp.asarray(y), jnp.asarray(dval), tab, p0))
    for L in WINDOW_L:
        y, dyws, starts, ny = _window_inputs(L)
        table = jnp.stack(list(j_acf.extract_aggregates(jnp.asarray(y[:ny]),
                                                        L)))
        p0 = j_acf.acf_from_aggregates(
            j_acf.extract_aggregates(jnp.asarray(y[:ny]), L), ny)
        out[f"window/{L}/table"], out[f"window/{L}/p0"] = np.asarray(table), \
            np.asarray(p0)
        for dt in DTYPES:
            cfg = SimpleNamespace(backend="reference", stat="acf",
                                  measure="mae")
            args = [jnp.asarray(a).astype(dt) for a in (y, dyws)]
            rows = jax.jit(lambda y_, d_, s_, t_: j_fused.window_rows(
                cfg, y_, d_, s_, t_, ny, L=L))(
                args[0], args[1], jnp.asarray(starts), table.astype(dt))
            out[f"window/{L}/{dt}/rows"] = np.asarray(rows)
            for m in MEASURES:
                out[f"window/{L}/{dt}/{m}"] = np.asarray(jax.jit(
                    lambda r, p, m=m: j_ref.measure_rows(r, p, m))(
                    rows, p0.astype(dt)))
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def strict(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_strict_public") / "strict.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", str(out)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _bits(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), float(np.max(np.abs(got - want)))


@pytest.mark.parametrize("L", LAGS)
def test_lags_arange(strict, L):
    for dt in DTYPES:
        _bits(t_acf.lags_arange(L, getattr(torch, dt)),
              strict[f"lags/{L}/{dt}"])


@pytest.mark.parametrize("n,L,seed", STATIONARY)
def test_acf_stationary(strict, n, L, seed):
    got = t_acf.acf_stationary(torch.from_numpy(_series(n, seed)), L)
    _bits(got, strict[f"stationary/{n}/{L}"])


def test_acf_after_single_delta(strict):
    tab = torch.from_numpy(strict["single/table"])
    rows = t_agg.acf_after_single_delta(
        tuple(tab), torch.from_numpy(_series(128, 9)),
        torch.tensor([0, 1, 63, 126, 127], dtype=torch.int32),
        torch.tensor([0.5, -1.0, 2.0, 0.1, -0.3], dtype=torch.float64))
    _bits(rows, strict["single/rows"])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,L", IMPACT)
def test_acf_impact(strict, n, L, dt):
    y, dval = _impact_inputs(n, L, dt)
    key = f"impact/{n}/{L}/{dt}"
    tab = torch.from_numpy(strict[key + "/table"])
    p0 = torch.from_numpy(strict[key + "/p0"])
    for m in MEASURES:
        got = t_ops.acf_impact(torch.from_numpy(y), torch.from_numpy(dval),
                               tuple(tab), p0, measure=m)
        _bits(got, strict[f"{key}/{m}"])


@pytest.mark.parametrize("L", WINDOW_L)
def test_window_rows(strict, L):
    y, dyws, starts, ny = _window_inputs(L)
    for dt in DTYPES:
        tdt = getattr(torch, dt)
        table = torch.from_numpy(strict[f"window/{L}/table"]).to(tdt)
        p0 = torch.from_numpy(strict[f"window/{L}/p0"]).to(tdt)
        args = (torch.from_numpy(y).to(tdt), torch.from_numpy(dyws).to(tdt),
                torch.from_numpy(starts), table, ny)
        for m in MEASURES:
            cfg = SimpleNamespace(backend="auto", stat="acf", measure=m)
            rows = t_fused.window_rows(cfg, *args, L=L)
            _bits(rows, strict[f"window/{L}/{dt}/rows"])
            _bits(t_fused.window_rows(cfg, *args, L=L, p0=p0),
                  strict[f"window/{L}/{dt}/{m}"])
            assert torch.equal(t_ref.measure_rows(rows, p0, m),
                               t_fused.window_rows(cfg, *args, L=L, p0=p0))


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; the hand-written "
                    "kernels run only there (chip_smoke.py drives them)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
def test_gpu_acf_impact_dispatch_is_the_kernel(cuda, dt):
    """On the card ``acf_impact`` is the kernel's launch, bit for bit, and
    launches it once."""
    from repro_torch.kernels.acf_impact import acf_impact_cuda
    y, dval = _impact_inputs(4096, 48, dt)
    y, dval = torch.from_numpy(y).to(cuda), torch.from_numpy(dval).to(cuda)
    agg = t_acf.extract_aggregates(y, 48)
    p0 = t_acf.acf_from_aggregates(agg, 4096).to(y.dtype)
    tab = t_ops.agg_to_table(agg).to(y.dtype).contiguous()
    for m in MEASURES:
        before = acf_impact_cuda.launches
        got = t_ops.acf_impact(y, dval, tab, p0, measure=m)
        assert acf_impact_cuda.launches == before + 1
        assert torch.equal(got, acf_impact_cuda(y, dval, tab, p0, L=48,
                                                measure=m))


@pytest.mark.gpu
def test_gpu_window_rows_dispatch_is_the_kernel(cuda):
    L = 12
    y, dyws, starts, ny = _window_inputs(L)
    y32 = torch.from_numpy(y).float().to(cuda)
    agg = t_acf.extract_aggregates(torch.from_numpy(y[:ny]).to(cuda), L)
    table = t_ops.agg_to_table(agg).float().contiguous()
    p0 = t_acf.acf_from_aggregates(agg, ny).float()
    args = (y32, torch.from_numpy(dyws).float().to(cuda),
            torch.from_numpy(starts).to(cuda), table,
            torch.tensor([ny], dtype=torch.int32, device=cuda))
    for m in MEASURES:
        cfg = SimpleNamespace(backend="auto", stat="acf", measure=m)
        before = t_fused.window_rows_cuda.launches
        got = t_fused.window_rows(cfg, *args, L=L, p0=p0)
        assert t_fused.window_rows_cuda.launches == before + 1
        assert torch.equal(got, t_fused.window_rows_cuda(*args, p0, L=L,
                                                         measure=m))


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
