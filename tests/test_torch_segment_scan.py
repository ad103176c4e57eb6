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
