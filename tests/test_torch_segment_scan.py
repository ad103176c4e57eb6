"""The ``segment_scan`` kernel's plain version and wrapper, the baselines'
entry points without a card, and, on a card only, the kernel against its
plain version and the baselines on the card against the same calls on the
CPU.  No JAX here: ``tests/test_torch_baselines.py`` holds the plain
version (through PMC and Swing) to the JAX reference.
"""
import numpy as np
import pytest
import torch

from repro_torch import baselines as tb
from repro_torch.baselines import constrain as tcon
from repro_torch.baselines import line_simpl as tls
from repro_torch.core.cameo import CameoConfig
from repro_torch.data.synthetic import dataset_cameo_kwargs, make_dataset
from repro_torch.kernels import segment_scan as ss


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


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (3 * np.sin(2 * np.pi * t / 24) + 0.3 * rng.standard_normal(n))


def _swing_oracle(x, err):
    """The Swing scan written out once more, literally, over numpy float64
    scalars: the break flags and the anchors."""
    t0, x0, u, l = 0.0, x[0], np.inf, -np.inf
    brk, x0s = [], []
    for i, xi in enumerate(x):
        t = float(i)
        dt = max(t - t0, 1.0)
        nu = min(u, (xi + err - x0) / dt)
        nl = max(l, (xi - err - x0) / dt)
        b = t0 != t and nl > nu
        if b:
            x0 = x0 + 0.5 * (u + l) * (t - 1.0 - t0)
            t0 = t - 1.0
            u, l = xi + err - x0, xi - err - x0
        else:
            u, l = nu, nl
        brk.append(b)
        x0s.append(x0)
    return np.array(brk), np.array(x0s)


@pytest.mark.parametrize("err", (0.01, 0.2, 1.5))
def test_plain_scans(err):
    """PMC's flags break exactly where a segment's range first exceeds
    2 err; Swing's equal a literal walk; a CPU call launches nothing."""
    x = _series(700, seed=1)
    before = ss.segment_scan_cuda.launches
    (brk,) = ss.segment_scan_cuda(torch.from_numpy(x), err, "pmc")
    starts = [0] + [int(i) for i in np.flatnonzero(brk.numpy())]
    for a, b in zip(starts, starts[1:] + [len(x)]):
        seg = x[a:b]
        assert seg.max() - seg.min() <= 2 * err
        if b < len(x):
            ext = x[a:b + 1]
            assert ext.max() - ext.min() > 2 * err
    out = ss.segment_scan_cuda(torch.from_numpy(x), err, "swing")
    want_brk, want_x0 = _swing_oracle(x, err)
    assert np.array_equal(out[0].numpy(), want_brk)
    assert np.array_equal(out[2].numpy().view(np.uint64),
                          want_x0.view(np.uint64))
    assert [o.dtype for o in out] == [torch.bool] + [torch.float64] * 4
    assert ss.segment_scan_cuda.launches == before


def _prefix(v, less):
    """``prefix`` of csrc/segment_scan.cu: the warp's inclusive scan by
    ``__shfl_up_sync`` steps 1, 2, 4, 8, 16, a lane keeping the earlier
    operand unless its own is strictly smaller (``less``) or larger."""
    v = list(v)
    s = 1
    while s < 32:
        nv = list(v)
        for lane in range(s, 32):
            o = v[lane - s]
            if not (v[lane] < o if less else v[lane] > o):
                nv[lane] = o
        v, s = nv, 2 * s
    return v


def _pmc_step(xw, nvalid, lo, hi, err2):
    """A PMC step of csrc/segment_scan.cu's pmc_kernel: the step's fold up
    to each point (the warp's prefix) and each point's own fold to the
    step's end with its first break (prepared by the other warps); the
    carried state joined to the prefix breaks the carried segment at the
    first lane whose range exceeds 2 err, and the breaks are followed from
    there.  Returns the step's flags, its break lanes and the state it
    leaves."""
    plo, phi = _prefix(xw, True), _prefix(xw, False)
    own, folds = [], []
    for lane in range(32):
        flo = fhi = xw[lane]
        first = 32
        for j in range(lane + 1, nvalid):
            flo = xw[j] if xw[j] < flo else flo
            fhi = xw[j] if xw[j] > fhi else fhi
            if first == 32 and (fhi - flo) > err2:
                first = j
        own.append(first)
        folds.append((flo, fhi))
    cl = [v if v < lo else lo for v in plo]
    ch = [v if v > hi else hi for v in phi]
    breaks = [j < nvalid and (ch[j] - cl[j]) > err2 for j in range(32)]
    at = breaks.index(True) if any(breaks) else 32
    flags, lanes, last = [False] * nvalid, [], -1
    while at < nvalid:
        flags[at] = True
        lanes.append(at)
        last, at = at, own[at]
    if last < 0:
        return flags, [32], cl[nvalid - 1], ch[nvalid - 1]
    return flags, lanes, folds[last][0], folds[last][1]


def _warp_model(xs, err, mode, f):
    """csrc/segment_scan.cu's walking warp, 32 points a step from i0.
    PMC: the step of ``_pmc_step``, the next from i0 + 32.  Swing: the
    cone closed by the prefix across the warp seeded with the carry, the
    first breaking lane (the ballot) ends the step, the next starts after
    it.  Returns the outputs and the lanes where steps broke (32: a step
    that carried its state into the next)."""
    n = len(xs)
    err = f(err)
    one, half, err2 = f(1.0), f(0.5), f(2.0) * f(err)
    lo, hi = f(np.inf), f(-np.inf)
    t0, x0, u, l = f(0.0), xs[0], f(np.inf), f(-np.inf)
    outs = [[None] * n for _ in range(1 if mode == "pmc" else 5)]
    lanes, i0 = [], 0
    while i0 < n:
        nvalid = min(32, n - i0)
        xw = [xs[i0 + j] if j < nvalid else f(0.0) for j in range(32)]
        if mode == "pmc":
            flags, got, lo, hi = _pmc_step(xw, nvalid, lo, hi, err2)
            outs[0][i0:i0 + nvalid] = flags
            lanes += got
            i0 += nvalid
            continue
        t = [f(i0 + j) for j in range(32)]
        dt = [t[j] - t0 for j in range(32)]
        dt = [v if v > one else one for v in dt]
        pu = _prefix([(xw[j] + err - x0) / dt[j] for j in range(32)], True)
        pl = _prefix([(xw[j] - err - x0) / dt[j] for j in range(32)], False)
        nu = [a if a < u else u for a in pu]
        nl = [a if a > l else l for a in pl]
        b = [j < nvalid and t0 != t[j] and nl[j] > nu[j] for j in range(32)]
        kb = b.index(True) if any(b) else nvalid
        for j in range(kb):
            for seq, v in zip(outs, (False, t0, x0, nu[j], nl[j])):
                seq[i0 + j] = v
        if not any(b):
            u, l = nu[nvalid - 1], nl[nvalid - 1]
            lanes.append(32)
            i0 += nvalid
            continue
        lanes.append(kb)
        up, lp = (nu[kb - 1], nl[kb - 1]) if kb else (u, l)
        tk = f(i0 + kb)
        x0 = x0 + half * (up + lp) * (tk - one - t0)
        t0 = tk - one
        dt2 = tk - t0
        dt2 = dt2 if dt2 > one else one
        a, c = xw[kb] + err - x0, xw[kb] - err - x0
        u = a if dt2 == one else a / dt2
        l = c if dt2 == one else c / dt2
        for seq, v in zip(outs, (True, t0, x0, u, l)):
            seq[i0 + kb] = v
        i0 += kb + 1
    return outs, lanes


def _segments_series(lengths, err, seed, swing):
    """A series of segments of the given lengths: PMC's levels (or
    Swing's lines) jump by 8 err between segments, with noise within
    +-err/4 of them, so most steps break where a segment ends."""
    rng = np.random.default_rng(seed)
    out, level, slope = [], 0.0, 0.0
    for n in lengths:
        level += 8 * err * rng.choice((-1, 1))
        slope = (rng.standard_normal() * err) if swing else 0.0
        base = level + slope * np.arange(n)
        out.append(base + rng.uniform(-err / 4, err / 4, n))
        level = base[-1]
    return np.concatenate(out)


def _hold_model(x, err, mode):
    """The warp model against the plain walk, bit for bit in every
    output; returns the model's break lanes."""
    f = ss._scalar_type(torch.from_numpy(x).dtype)
    xs = x.tolist() if f is float else list(x)
    got, lanes = _warp_model(xs, err, mode, f)
    want = ss.segment_scan_plain(torch.from_numpy(x), err, mode)
    assert np.array_equal(np.array(got[0]), want[0].numpy())
    for g, w in zip(got[1:], want[1:]):
        g = np.array(g, dtype=x.dtype)
        w = w.numpy()
        assert np.array_equal(g.view(f"u{x.dtype.itemsize}"),
                              w.view(f"u{x.dtype.itemsize}"))
    return lanes


# segment lengths: breaks at a step's first and last lanes (Swing's steps
# start after a break: 1 and 32; PMC's at multiples of 32: 31 and 63, 64),
# segments longer than a step (33, 64, 65, 100)
LENGTHS = (31, 32, 1, 32, 33, 64, 1, 65, 5, 31, 2, 100, 3, 1, 1, 32, 40)


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("mode", ss.MODES)
def test_warp_model_breaks_at_window_edges(mode, dtype):
    """Breaks at a step's first and last lane and segments longer than 32
    points: the warp's steps give the walk's bits."""
    err = 0.3
    x = _segments_series(LENGTHS, err, seed=3,
                         swing=mode == "swing").astype(dtype)
    lanes = _hold_model(x, err, mode)
    assert 0 in lanes and 32 in lanes
    if mode == "pmc":
        assert 31 in lanes


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("err", (0.01, 0.2, 1.5))
@pytest.mark.parametrize("mode", ss.MODES)
def test_warp_model_equals_plain(mode, err, dtype):
    x = _series(1500, seed=4).astype(dtype)
    _hold_model(x, err, mode)


@pytest.mark.parametrize("err", (0.0, -0.0))
@pytest.mark.parametrize("mode", ss.MODES)
def test_warp_model_signed_zero_ties(mode, err):
    """A series of +0, -0 and a few ones from x0 = +0 at err +0 (the lower
    slopes (x - err) - x0 are -0 at x = -0, +0 at x = +0) and at err -0
    (the upper slopes likewise): the cone's prefix meets ties of +0 and
    -0 and keeps the earlier zero, as the walk does (fmin and fmax would be
    free to take either)."""
    rng = np.random.default_rng(7)
    x = rng.choice(np.array([0.0, -0.0, 0.0, -0.0, 1.0]), 600)
    x[0] = 0.0
    _hold_model(x, err, mode)
    if mode == "swing":
        out = ss.segment_scan_plain(torch.from_numpy(x), err, "swing")
        side = out[4 if np.signbit(err) == 0 else 3].numpy()
        zeros = side[side == 0]
        assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()


def test_plain_scan_float32_rounds_in_float32():
    x32 = _series(300, seed=2).astype(np.float32)
    out = ss.segment_scan_plain(torch.from_numpy(x32), 0.2, "swing")
    assert [o.dtype for o in out[1:]] == [torch.float32] * 4
    # the same walk in float64 rounds otherwise somewhere
    out64 = ss.segment_scan_plain(torch.from_numpy(x32.astype(np.float64)),
                                  0.2, "swing")
    assert not np.array_equal(out[3].numpy().astype(np.float64),
                              out64[3].numpy())


def test_plain_scan_rejects_bad_input():
    with pytest.raises(ValueError, match="mode"):
        ss.segment_scan_plain(torch.zeros(4, dtype=torch.float64), 0.1, "x")
    with pytest.raises(ValueError, match="one series"):
        ss.segment_scan_plain(torch.zeros(2, 4, dtype=torch.float64), 0.1,
                              "pmc")
    with pytest.raises(TypeError):
        ss.segment_scan_plain(torch.zeros(4, dtype=torch.int64), 0.1, "pmc")


ENTRY_POINTS = {
    "compress_baseline": lambda x, cfg, **d: tls.compress_baseline(
        x, cfg, "vw", **d),
    "constrained_removal": lambda x, cfg, **d: tb.constrained_removal(
        x, cfg, tb.vw_rank, **d),
    "pmc_compress": lambda x, cfg, **d: tb.pmc_compress(x, 0.3, **d),
    "swing_compress": lambda x, cfg, **d: tb.swing_compress(x, 0.3, **d),
    "simpiece_compress": lambda x, cfg, **d: tb.simpiece_compress(x, 0.3,
                                                                  **d),
    "fft_compress": lambda x, cfg, **d: tb.fft_compress(x, 8, **d),
    "acf_deviation": lambda x, cfg, **d: tcon.acf_deviation(x, x, cfg, **d),
    "acf_constrained_search": lambda x, cfg, **d: tb.acf_constrained_search(
        x, cfg, tb.pmc_compress, iters=2, **d),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_card_or_cpu(entry):
    """Every entry point runs on the card by default and raises without
    one; ``device="cpu"`` runs the plain path."""
    x, cfg = _series(256), CameoConfig(eps=0.05, lags=8)
    fn = ENTRY_POINTS[entry]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x, cfg)
    out = fn(x, cfg, device="cpu")
    tensors = [v for v in (out if isinstance(out, tuple) else (out,))
               if isinstance(v, torch.Tensor)]
    assert all(t.device.type == "cpu" for t in tensors)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
@pytest.mark.parametrize("name", ("uk_elec", "aus_elec"))
@pytest.mark.parametrize("mode", ss.MODES)
def test_gpu_segment_scan_equals_plain(cuda, name, mode, dtype):
    """The kernel equals its plain version bit for bit at the dataset's
    full length, at two error bounds, in the series' type; one launch a
    call."""
    x = torch.from_numpy(make_dataset(name, seed=0)).to(dtype)
    spread = float(x.max() - x.min())
    for err in (1e-3 * spread, 1e-2 * spread):
        before = ss.segment_scan_cuda.launches
        got = ss.segment_scan_cuda(x.to(cuda), err, mode)
        torch.cuda.synchronize()
        assert ss.segment_scan_cuda.launches == before + 1
        want = ss.segment_scan_plain(x, err, mode)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (mode, err)


@pytest.mark.gpu
@pytest.mark.parametrize("rank", sorted(tls.LINE_SIMPL_BASELINES))
def test_gpu_compress_baseline_equals_cpu(cuda, rank):
    """compress_baseline on the card (lag_dot, prefix_sum, dense_sxx) gives
    the CPU path's result in every field and every round's (accepted,
    picks, deviation) at uk_elec's first 4,096 points (ROADMAP C16)."""
    x = make_dataset("uk_elec", seed=0, length=4096)
    cfg = CameoConfig(eps=1e-2, **dataset_cameo_kwargs("uk_elec"))
    t_card, t_cpu = [], []
    card = tls.compress_baseline(x, cfg, rank, device=cuda, trace=t_card)
    cpu = tls.compress_baseline(x, cfg, rank, device="cpu", trace=t_cpu)
    assert t_card == t_cpu
    for f in ("kept", "xr", "deviation", "n_kept", "iters", "stat_orig",
              "stat_new"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert float(card.deviation) <= cfg.eps


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("method", ("pmc", "swing"))
def test_gpu_functional_equals_cpu(cuda, method, dtype):
    """PMC and Swing on the card give the CPU path's reconstruction bit for
    bit (the kernel, then exact segment arithmetic), on a float32 series
    too (PMC keeps its type, Swing takes float64)."""
    fn = {"pmc": tb.pmc_compress, "swing": tb.swing_compress}[method]
    x = make_dataset("uk_elec", seed=0).astype(dtype)
    err = 0.01 * float(x.max() - x.min())
    got, s1 = fn(x, err, device=cuda)
    want, s2 = fn(x, err, device="cpu")
    assert s1 == s2 and torch.equal(got.cpu(), want)


def test_chip_smoke_baselines_rehearsal():
    """chip_smoke.py's baselines phase at a tiny size on the CPU, where
    every wrapper takes its plain version: uk_elec's runs held to the CPU
    references from the worker pool, the searches' parameters, the lossless
    counters, and segment_scan's holds at both datasets in both modes."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    sizes = {"uk_elec": 512, "aus_elec": 48 * 48}
    pool, refs = chip_smoke.baseline_references("uk_elec", sizes["uk_elec"])
    try:
        bl = chip_smoke.run_baselines("cpu", sizes=sizes, refs=refs,
                                      log=lambda s: None)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    rows = bl["rows"]
    assert [(r["dataset"], r["method"]) for r in rows] == [
        (d, m) for d in ("uk_elec", "aus_elec")
        for m in list(tls.LINE_SIMPL_BASELINES) + ["pmc", "swing",
                                                  "simpiece", "fft"]]
    uk = [r for r in rows if r["dataset"] == "uk_elec"]
    assert all(r["deviation_bits_equal"] for r in uk)
    assert all(r["same_kept"] for r in uk if "rounds" in r)
    assert all(r["param"] == r["param_cpu"] for r in uk if "param" in r)
    assert set(bl["lossless"]) == {"uk_elec", "aus_elec"}
    assert [(k["dataset"], k["shape"].split()[0]) for k in bl["kernels"]] \
        == [(d, m) for d in ("uk_elec", "aus_elec") for m in ss.MODES]
    assert all(k["max_abs_err"] == 0.0 for k in bl["kernels"])
    assert bl["launches"] == dict.fromkeys(chip_smoke.WRAPPERS, 0)
    rows = chip_smoke.kernel_rows({"kernels": bl["kernels"],
                                   "launches": bl["launches"]},
                                  ["segment_scan"])
    assert [r["name"] for r in rows] == ["segment_scan"]
