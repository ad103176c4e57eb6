"""The dense update's bilinear term (``kernels/dense_sxx.py``): a Python
model of the kernel's walk (``csrc/dense_sxx.cu``) against the plain
version, bit for bit, over row lengths around XLA's block bounds; why the
term needed its own kernel (ROADMAP C16: ``lag_dot``'s two chains sum it in
another order); and, on a card only, the kernel against its plain version
and a rounds run on the card against the CPU's in every field.  No JAX
here: the plain version's order is held to the strict-compiled reference
by the rounds tests (``tests/test_torch_cameo.py``, ``test_torch_sums.py``)
and the baselines' (``tests/test_torch_baselines.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cameo as tc
from repro_torch.data.synthetic import dataset_cameo_kwargs, make_dataset
from repro_torch.kernels import dense_sxx as ds
from repro_torch.kernels.lag_dot import lag_dot_plain
from repro_torch.kernels.ref import xla_row_blocks

# (nyb, ny, L): one block, a short row, a row padded at both ends, a
# second level of one block, three levels, the datasets' rounds buckets
SHAPES = ((1, 1, 3), (17, 17, 4), (32, 30, 5), (33, 33, 7), (100, 90, 7),
          (1024, 1024, 12), (1025, 1000, 12), (5120, 4806, 7),
          (18432, 17520, 48), (40000, 39000, 3))


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


def _inputs(nyb, ny, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(nyb)
    d = np.where(rng.random(nyb) < 0.2, 0.1 * rng.standard_normal(nyb), 0.0)
    y[ny:] = 0.0
    d[ny:] = 0.0
    return y, d


def _starts(k):
    sizes = xla_row_blocks(k)
    return [sum(sizes[:b]) for b in range(len(sizes))], sizes


def _kernel_model(y, d, ny, L):
    """``csrc/dense_sxx.cu``'s walk, one (lane, lag) at a time: a lane of a
    warp chains a first-level block's kept terms from +0, lane 0 chains the
    warp's block sums into a second-level sum, and the levels above are
    reduced block by block to one value."""
    nyb = len(y)
    st1, sz1 = _starts(nyb)
    st2, sz2 = _starts(len(sz1))
    out = []
    for lag in range(1, L + 1):
        head = ny - 1 - lag
        level = []
        for j in range(len(sz2)):
            acc = 0.0
            for b in range(st2[j], st2[j] + sz2[j]):
                s = 0.0
                for t in range(st1[b], min(st1[b] + sz1[b], head + 1)):
                    ds_ = d[t + lag]
                    s = s + (d[t] * (y[t + lag] + ds_) + y[t] * ds_)
                acc = acc + s
            level.append(acc)
        while len(level) > 1:
            st, sz = _starts(len(level))
            nxt = []
            for b in range(len(sz)):
                acc = 0.0
                for v in level[st[b]:st[b] + sz[b]]:
                    acc = acc + v
                nxt.append(acc)
            level = nxt
        out.append(level[0])
    return np.array(out)


@pytest.mark.parametrize("nyb,ny,L", [s for s in SHAPES if s[0] <= 5120])
def test_kernel_walk_equals_plain(nyb, ny, L):
    y, d = _inputs(nyb, ny)
    want = ds.dense_sxx_cuda(torch.from_numpy(y), torch.from_numpy(d), ny, L)
    got = _kernel_model(y.tolist(), d.tolist(), ny, L)
    assert np.array_equal(got.view(np.uint64), want.numpy().view(np.uint64))


def test_lanes_equal_one_lane():
    ys, dsl = zip(*(_inputs(1025, 1000 - 7 * b, seed=b) for b in range(3)))
    y, d = torch.from_numpy(np.stack(ys)), torch.from_numpy(np.stack(dsl))
    ny = torch.tensor([1000, 993, 986], dtype=torch.int32)
    got = ds.dense_sxx_cuda(y, d, ny, 9)
    assert got.shape == (3, 9)
    for b in range(3):
        assert torch.equal(got[b], ds.dense_sxx_cuda(y[b], d[b], ny[b], 9))


def test_lag_dot_chains_part_from_roll_order():
    """ROADMAP C16's cause: the card's dense update summed the term as two
    ``lag_dot`` chains (each lag's products first to last, then the two
    sums added), the CPU path one term a point in XLA's row-reduce order;
    the two orders part in the last bits of most lags."""
    y, d = _inputs(18432, 17520)
    yt, dt = torch.from_numpy(y), torch.from_numpy(d)
    chains = (lag_dot_plain(dt, yt + dt, L=48) + lag_dot_plain(yt, dt, L=48))
    roll = ds.dense_sxx_plain(yt, dt, 17520, 48)
    assert torch.allclose(chains, roll, rtol=1e-12, atol=1e-12)
    assert int((chains != roll).sum()) > 24


def test_wrapper_on_cpu_is_plain():
    """A CPU tensor takes the plain version and launches nothing."""
    y, d = _inputs(300, 280)
    before = ds.dense_sxx_cuda.launches
    got = ds.dense_sxx_cuda(torch.from_numpy(y), torch.from_numpy(d),
                            torch.tensor(280), 6)
    assert ds.dense_sxx_cuda.launches == before
    assert torch.equal(got, ds.dense_sxx_plain(torch.from_numpy(y),
                                               torch.from_numpy(d), 280, 6))


@pytest.mark.gpu
def test_gpu_dense_sxx_rejects_bad_input(cuda):
    z = torch.zeros(2, 3, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        ds.dense_sxx_cuda(z, z, 4, 2)
    with pytest.raises(TypeError):
        ds.dense_sxx_cuda(z[0].long(), z[0].long(), 4, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("nyb,ny,L", SHAPES)
def test_gpu_dense_sxx_equals_plain(cuda, nyb, ny, L):
    y, d = _inputs(nyb, ny)
    yt, dt = torch.from_numpy(y), torch.from_numpy(d)
    before = ds.dense_sxx_cuda.launches
    got = ds.dense_sxx_cuda(yt.to(cuda), dt.to(cuda), ny, L)
    assert ds.dense_sxx_cuda.launches == before + 1
    assert torch.equal(got.cpu(), ds.dense_sxx_plain(yt, dt, ny, L))
    lanes = torch.stack([yt, yt.flip(0)]).to(cuda)
    dl = torch.stack([dt, dt.flip(0)]).to(cuda)
    nys = torch.tensor([ny, ny], dtype=torch.int32, device=cuda)
    got2 = ds.dense_sxx_cuda(lanes, dl, nys, L)
    assert torch.equal(got2[0], got)
    assert torch.equal(got2[1].cpu(), ds.dense_sxx_plain(
        lanes[1].cpu(), dl[1].cpu(), ny, L))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("uk_elec", "aus_elec"))
def test_gpu_rounds_equal_cpu(cuda, name):
    """The rounds mode on the card gives the CPU path's result in every
    field, the deviation's bits included (ROADMAP C16)."""
    x = make_dataset(name, seed=0, length=4096 if name == "uk_elec"
                     else 48 * 120)
    cfg = tc.CameoConfig(eps=1e-2, **dataset_cameo_kwargs(name))
    card = tc.compress(x, cfg, device=cuda)
    cpu = tc.compress(x, cfg, device="cpu")
    for f in ("kept", "xr", "deviation", "n_kept", "iters", "stat_orig",
              "stat_new"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
