"""``kernels/cell_sum.py``: the Eq. 9 aggregate map's cell sums (ROADMAP
C20).

On the CPU the plain version is held bit for bit to a loop that adds each
cell's terms left to right from +0 and divides once (strict XLA's
``segment_sum`` order; ``tests/test_torch_segment_fma.py`` holds the same
map to strict JAX itself), and ``ops.x_window_to_y`` takes it for CPU
tensors.  On the card (``-m gpu``) the kernel is held to the plain version
at tolerance 0, on one series and with a lane axis, in both types.  No
JAX here: the ``gpu`` tests run on the machine with the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cameo import CameoConfig
from repro_torch.kernels import ops
from repro_torch.kernels.cell_sum import cell_sum_cuda, cell_sum_plain

# (kappa, W): aus_elec's tiers B and C (kappa 48), kappa 4 and a window
# longer than three cells
CASES = [(48, 8), (48, 64), (4, 64), (3, 20), (2, 8)]


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


def _windows(shape, W, dt, seed=0):
    """Windows with the terms' magnitudes spread over 2^±20 (so the order
    of a cell's adds shows in its bits), a few -0 terms, and starts."""
    rng = np.random.default_rng(seed + W)
    x = rng.standard_normal(shape + (W,)) * np.exp2(
        rng.integers(-20, 20, shape + (W,)))
    x[..., ::7] = -0.0
    start = rng.integers(0, 10_000, shape).astype(np.int32)
    return torch.from_numpy(x.astype(dt)), torch.from_numpy(start)


def _loop(x: np.ndarray, start: np.ndarray, kap: int) -> np.ndarray:
    """Each cell's terms added one at a time from +0 in the windows' type,
    then divided by kappa."""
    W = x.shape[-1]
    xs, ss = x.reshape(-1, W), start.reshape(-1)
    out = np.zeros((xs.shape[0], W // kap + 2), x.dtype)
    for r in range(xs.shape[0]):
        for j in range(W):
            c = (ss[r] + j) // kap - ss[r] // kap
            out[r, c] = out[r, c] + xs[r, j]
    return (out / x.dtype.type(kap)).reshape(x.shape[:-1] + (-1,))


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


@pytest.mark.parametrize("dt", ("float32", "float64"))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"k{c[0]}-W{c[1]}")
def test_plain_equals_left_to_right_loop(case, dt):
    kap, W = case
    x, start = _windows((3, 37), W, dt)
    got = cell_sum_plain(x, start, kap)
    assert got.dtype == x.dtype and got.shape == (3, 37, W // kap + 2)
    np.testing.assert_array_equal(
        _bits(got.numpy()), _bits(_loop(x.numpy(), start.numpy(), kap)))
    # one window (0-d start), as the sequential mode's pop passes it
    one = cell_sum_plain(x[1, 5], start[1, 5], kap)
    np.testing.assert_array_equal(_bits(one.numpy()),
                                  _bits(got[1, 5].numpy()))
    # no +0 cell turns -0, and an empty cell is +0
    assert not np.any(np.signbit(got.numpy()) & (got.numpy() == 0))


def test_x_window_to_y_takes_the_plain_version_on_the_cpu():
    cfg = CameoConfig(kappa=48, lags=7, dtype="float32")
    x, start = _windows((5,), 64, "float32", seed=3)
    dyw, ystart = ops.x_window_to_y(cfg, x, start)
    assert torch.equal(dyw, cell_sum_plain(x, start, 48))
    assert torch.equal(ystart, start // 48)
    assert cell_sum_cuda(x, start, 48).device.type == "cpu"
    ident = ops.x_window_to_y(CameoConfig(kappa=1), x, start)
    assert ident[0] is x and ident[1] is start


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ("float32", "float64"))
@pytest.mark.parametrize("shape", ((10_240,), (4, 5_120), ()),
                         ids=("one-series", "lanes", "one-window"))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"k{c[0]}-W{c[1]}")
def test_kernel_equals_plain_on_card(cuda, case, shape, dt):
    kap, W = case
    x, start = _windows(shape, W, dt, seed=9)
    x, start = x.to(cuda), start.to(cuda)
    before = cell_sum_cuda.launches
    got = cell_sum_cuda(x, start, kap)
    assert cell_sum_cuda.launches == before + 1
    want = cell_sum_plain(x, start, kap)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(want.cpu().numpy()))
    np.testing.assert_array_equal(
        _bits(got.cpu().numpy()),
        _bits(cell_sum_plain(x.cpu(), start.cpu(), kap).numpy()))
