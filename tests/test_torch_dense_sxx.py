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

# (nyb, ny, L): one block, a short row, a row padded at both ends, a
# second level of one block, three levels, the datasets' rounds buckets;
# then past 32 lags (33, 64, min_temp's 365 on 4,096 and on its bucket),
# and rows whose second-level blocks cross the cluster's 8 tiles (8, 9,
# 17) or 32 (the tiles then own third-level blocks)
SHAPES = ((1, 1, 3), (17, 17, 4), (32, 30, 5), (33, 33, 7), (100, 90, 7),
          (1024, 1024, 12), (1025, 1000, 12), (5120, 4806, 7),
          (18432, 17520, 48), (40000, 39000, 3),
          (2048, 2000, 33), (4096, 4000, 64), (4096, 3650, 365),
          (8192, 8000, 12), (8200, 8200, 9), (16500, 16400, 20),
          (32900, 32800, 5), (3840, 3650, 365))


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


# csrc/dense_sxx.cu's constants
K_WARPS, K_U, K_MAX_CLUSTER, K_MAX_CHUNK = 8, 2, 8, 4
K_MIN_BLOCKS, K_MIN_LAGS, K_SMEM_MAX = 512, 4, 227 * 1024


def _cdiv(a, b):
    return -(-a // b)


def _n_blocks(k):
    return 1 if k <= 32 else _cdiv(k, 32)


def _lead(k):
    return 0 if k <= 32 else (-k % 32) // 2


def _blk(k, b):
    """Block b of a level of k values: [first, end)."""
    return max(32 * b - _lead(k), 0), min(32 * b + 32 - _lead(k), k)


def _plan(nyb, L, B, itemsize):
    """``make_plan`` of csrc/dense_sxx.cu: the tiles (a cluster of C), the
    units they own, the lag group G and its packs P, the chunk and the
    segment slots."""
    n1 = _n_blocks(nyb)
    n2 = _n_blocks(n1)
    unit3 = n2 > 32
    nu = _n_blocks(n2) if unit3 else n2
    upt = _cdiv(nu, K_MAX_CLUSTER)
    p = dict(n1=n1, n2=n2, unit3=unit3, nu=nu, upt=upt, C=_cdiv(nu, upt),
             s2cap=32 * upt if unit3 else upt)
    found, g = None, min(L, 32)
    while True:
        P, fit = 32 // g, None
        for kc in range(min(p["s2cap"], K_MAX_CHUNK), 0, -1):
            segcap = 32 * _cdiv(32 * _cdiv(32 * kc, P) + L, 32) + 32
            smem = 16 + itemsize * (2 * P * segcap
                                    + (32 * kc + p["s2cap"] + nu) * g)
            if smem <= K_SMEM_MAX:
                fit = dict(p, G=g, P=P, kc=kc, segcap=segcap)
                break
        if fit:
            found = fit
            if B * _cdiv(L, g) * p["C"] >= K_MIN_BLOCKS:
                break
        nxt = max(K_MIN_LAGS, _cdiv(g, 2))
        if g <= K_MIN_LAGS or (32 // nxt) * L > 1024 * min(p["s2cap"],
                                                          K_MAX_CHUNK):
            break
        g = nxt
    return found


def _slot(q, segcap, G, itemsize):
    """``slot`` of csrc/dense_sxx.cu: where segment q's values begin."""
    return q * (segcap + G) + (q * G // 16 if itemsize == 8 else 0)


def _row_block(n, b):
    """rn::row_block."""
    if n <= 32:
        return n
    pad = -n % 32
    lo, nw = pad // 2, (n + pad) // 32
    return 32 - lo if b == 0 else 32 - (pad - lo) if b == nw - 1 else 32


def _chain(vals, zero):
    acc = zero
    for v in vals:
        acc = acc + v
    return acc


def _rn_row_sum(vals, zero):
    """rn::row_sum<T, false> over ``vals`` (one chain up to 32; past that
    the block walk of rn::row_sum_blocks)."""
    n = len(vals)
    if n <= 32:
        return _chain(vals, zero)
    n1, total, b0, b1, i = _cdiv(n, 32), zero, 0, 0, 0
    while b0 < n1:
        s1, end = zero, b0 + _row_block(n1, b1)
        while b0 < end:
            m = _row_block(n, b0)
            s1 = s1 + _chain(vals[i:i + m], zero)
            i, b0 = i + m, b0 + 1
        total, b1 = total + s1, b1 + 1
    return total


def _kernel_model(y, d, ny, L, B=1):
    """``csrc/dense_sxx.cu`` for one lane of a launch of ``B`` lanes, block
    by block as the kernel schedules it: each tile's chunks staged into
    the packs' segment slots (unstaged slots NaN, so a read off the staged
    values shows), the first-level chains of every (pack, block, lag) lane
    read at the kernel's slot positions, the second-level chains, the
    tile's unit sums into block 0's ``top``, and block 0's rn::row_sum."""
    y, d = np.asarray(y), np.asarray(d)
    dt, nyb = y.dtype, len(y)
    zero = dt.type(0)
    p = _plan(nyb, L, B, dt.itemsize)
    G, P, segcap, kc = p["G"], p["P"], p["segcap"], p["kc"]
    n1, n2, lo1 = p["n1"], p["n2"], _lead(nyb)
    out = np.empty(L, dt)
    pk = np.arange(P)[:, None, None]
    jl = np.arange(G)[None, None, :]
    for grp in range(_cdiv(L, G)):
        l0 = grp * G
        nl = min(G, L - l0)
        hal = l0 + nl
        top = np.full((p["nu"], G), np.nan, dt)
        for r in range(p["C"]):
            u0 = r * p["upt"]
            u1 = min(u0 + p["upt"], p["nu"])
            j0, j1 = ((_blk(n2, u0)[0], _blk(n2, u1 - 1)[1]) if p["unit3"]
                      else (u0, u1))
            s2 = np.full((p["s2cap"], G), np.nan, dt)
            for c0 in range(j0, j1, kc):
                c1 = min(c0 + kc, j1)
                bs, be = _blk(n1, c0)[0], _blk(n1, c1 - 1)[1]
                sp = _cdiv(be - bs, P)
                ys = np.full(P * segcap, np.nan, dt)
                ds_ = np.full(P * segcap, np.nan, dt)
                for q in range(P):
                    pb0, pb1 = bs + q * sp, min(bs + q * sp + sp, be)
                    if pb0 >= pb1:
                        break
                    t = 32 * pb0 - lo1 + np.arange(32 * (pb1 - pb0) + hal)
                    inside = (t >= 0) & (t < nyb)
                    tc = np.clip(t, 0, nyb - 1)
                    base = _slot(q, segcap, G, dt.itemsize)
                    ys[base:base + len(t)] = np.where(inside, y[tc], zero)
                    ds_[base:base + len(t)] = np.where(inside, d[tc], zero)
                # lanes (pack, lag) x the pack's blocks m, each a chain
                m = np.arange(sp)[None, :, None]
                pb0 = bs + pk * sp
                pnb = np.clip(be - pb0, 0, sp)
                lag = l0 + jl + 1
                live = (jl < nl) & (m < pnb)
                s = np.zeros((P, sp, G), dt)
                for k in range(32):
                    i = _slot(pk, segcap, G, dt.itemsize) + 32 * m + k
                    t = 32 * (pb0 + m) + k - lo1
                    yl, dl = ys[i + lag], ds_[i + lag]
                    term = ds_[i] * (yl + dl) + ys[i] * dl
                    keep = live & (t >= 0) & (t <= ny - 1 - lag)
                    s = np.where(keep, s + term, s)
                s1 = np.full((32 * kc, G), np.nan, dt)
                for q, mm, jj in zip(*np.nonzero(np.broadcast_to(
                        live, s.shape))):
                    s1[q * sp + mm, jj] = s[q, mm, jj]
                for c in range(c0, c1):
                    a, e = _blk(n1, c)
                    for jj in range(nl):
                        s2[c - j0, jj] = _chain(s1[a - bs:e - bs, jj], zero)
            for uu in range(u0, u1):
                for jj in range(nl):
                    if p["unit3"]:
                        a, e = _blk(n2, uu)
                        top[uu, jj] = _chain(s2[a - j0:e - j0, jj], zero)
                    else:
                        top[uu, jj] = s2[uu - j0, jj]
        for jj in range(nl):
            out[l0 + jj] = _rn_row_sum(list(top[:, jj]), zero)
    return out


@pytest.mark.parametrize("nyb,ny,L", SHAPES)
def test_kernel_walk_equals_plain(nyb, ny, L):
    """The kernel's schedule gives the plain version's bits, for a launch
    of one lane (the smallest lag groups, packed blocks) and of 16."""
    y, d = _inputs(nyb, ny)
    want = ds.dense_sxx_cuda(torch.from_numpy(y), torch.from_numpy(d), ny, L)
    for B in (1, 16):
        got = _kernel_model(y, d, ny, L, B)
        assert np.array_equal(got.view(np.uint64),
                              want.numpy().view(np.uint64)), B


def test_kernel_walk_equals_plain_float32():
    y, d = (v.astype(np.float32) for v in _inputs(5120, 4806))
    want = ds.dense_sxx_plain(torch.from_numpy(y), torch.from_numpy(d),
                              4806, 7)
    got = _kernel_model(y, d, 4806, 7)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("nyb,L,B,plan", [
    # one uk_elec series: 6 tiles of 3 second-level blocks, 4 lags a
    # block in 8 packs; 16 lanes: 8 lags in 4 packs
    (18432, 48, 1, dict(C=6, upt=3, G=4, P=8, kc=3, unit3=False)),
    (18432, 48, 16, dict(C=6, upt=3, G=8, P=4, kc=3, unit3=False)),
    # aus_elec: 5 tiles, L = 7 in groups of 4
    (5120, 7, 1, dict(C=5, upt=1, G=4, P=8, kc=1)),
    # 365 lags: two packs, their halos no larger than the chunk; a third
    # level of two blocks (the tiles own third-level blocks)
    (4096, 365, 1, dict(C=4, G=16, P=2, kc=1)),
    (40000, 3, 1, dict(C=2, upt=1, unit3=True, nu=2, G=3, P=10, kc=4)),
    (1, 3, 1, dict(C=1, nu=1, G=3)),
    # the longest row at the largest L fits shared memory
    (2048 * 1024, 4096, 1, dict(C=8, unit3=True, nu=64)),
])
def test_kernel_plan(nyb, L, B, plan):
    """The schedule the model (and the kernel) takes at the datasets'
    shapes and the limits."""
    got = _plan(nyb, L, B, 8)
    assert got is not None
    assert {k: got[k] for k in plan} == plan


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
