"""``kernels/segment_cells.py``: the Eq. 9 delta windows from a segment's
endpoints to their cells in one launch (ROADMAP C19, C20), on the CPU.

The plain version, ``segment_deltas`` and then at kappa > 1
``cell_sum_plain``, is held bit for bit to strict-compiled JAX
(``--xla_disable_hlo_passes=algsimp --xla_backend_optimization_level=0``,
in a subprocess) running the reference's ``x_window_to_y(cfg,
*segment_deltas(...)[:2])`` and the span, at kappa 1, 2, 4 and 48, in
float32 and float64, at W 8 and 64, for candidates of every shape the
paths pass (0-d, ``[K]``, ``[B, K]`` and ``[T, K]`` with one row for every
partition), with the endpoints, negative candidates and segments past W
among them.  A Python model of the kernel's schedule (a warp a window,
lane 0's loads, a lane a cell) is held to the plain version bit for bit;
``ops.segment_cells`` takes the plain version for CPU tensors, and every
path reaches it.  On the card (``-m gpu``) the kernel is held to the plain
version at tolerance 0.  JAX is imported only in the strict subprocess and
in the test that holds this file's geometry to ``test_torch_segment_fma``'s
``_windows``, so the ``gpu`` tests run on the machine with the card.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import cameo as tc
from repro_torch.core import parallel as tpar
from repro_torch.core.aggregates import alive_neighbors
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_cells as seg
from repro_torch.kernels.ref import fma_rn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_torch_segment_fma.py's strict compilation
STRICT_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                    "--xla_backend_optimization_level=0")
N = 1024
K = 24
LANES = 3
PARTS = 4
FORMS = ("0d", "K", "BK", "TK")
# (dtype, kappa, W, form)
CASES = [(dt, kap, W, form) for dt in ("float32", "float64")
         for kap in (1, 2, 4, 48) for W in (8, 64) for form in FORMS]


def _case_id(case):
    return f"{case[0]}-k{case[1]}-W{case[2]}-{case[3]}"


def _windows_draw(dt: str, W: int, seed: int):
    """``test_torch_segment_fma._windows``' reconstruction and alive mask
    (its draws, in its order: 30% of 1,024 points alive, the endpoints
    too)."""
    rng = np.random.default_rng(seed + W)
    xr = (rng.standard_normal(N) * 3).astype(dt)
    alive = rng.random(N) < 0.3
    alive[0] = alive[-1] = True
    return xr, alive


def _lane(dt: str, W: int, b: int):
    """(xr, prev, nxt, cand) of lane ``b``: ``_windows``' reconstruction
    and alive mask with a stretch of 150 points removed (two segments past
    W), and ``K`` candidates: the endpoints, -1, -(n + 5) (wraps once, then
    clamps to 0), the two points bounding the stretch and alive interior
    points."""
    xr, alive = _windows_draw(dt, W, b)
    lo = 200 + 131 * b
    alive[lo:lo + 150] = False
    prev, nxt = (a.numpy() for a in alive_neighbors(torch.from_numpy(alive)))
    inner = np.nonzero(alive[1:-1])[0] + 1
    rng = np.random.default_rng(17 + b + W)
    special = [0, N - 1, -1, -(N + 5), prev[lo], nxt[lo]]
    cand = np.concatenate([special, rng.choice(inner, K - len(special))])
    return xr, prev, nxt, cand.astype(np.int32)


def _inputs(case):
    """The numpy inputs of ``case``: ``xr``, ``prev``, ``nxt`` of one lane
    (0-d and ``[K]``) or of ``LANES`` / ``PARTS`` lanes, and the candidates
    (``[K]`` of lane 0 taken one at a time for 0-d; one row for every
    partition at ``TK``)."""
    dt, _, W, form = case
    lanes = {"0d": 1, "K": 1, "BK": LANES, "TK": PARTS}[form]
    per = [_lane(dt, W, b) for b in range(lanes)]
    xr, prev, nxt, cand = (np.stack(a) for a in zip(*per))
    if form in ("0d", "K"):
        return xr[0], prev[0], nxt[0], cand[0]
    if form == "TK":
        return xr, prev, nxt, cand[0]
    return xr, prev, nxt, cand


def _reference_main(out):
    """Strict JAX's cells, ystart and span for every case."""
    import jax
    import jax.numpy as jnp
    from repro.core import cameo as jc
    from repro.core.aggregates import segment_deltas as j_segment_deltas
    from repro.kernels import ops as jops
    jax.config.update("jax_enable_x64", True)
    res = {}
    for case in CASES:
        dt, kap, W, form = case
        cfg = jc.CameoConfig(kappa=kap, lags=8, dtype=dt)

        def one(xr, prev, nxt, i):
            dwin, start, span = j_segment_deltas(xr, prev, nxt, i, W)
            dyw, ystart = jops.x_window_to_y(cfg, dwin, start)
            return dyw, ystart, span
        xr, prev, nxt, cand = (jnp.asarray(a) for a in _inputs(case))
        if form == "0d":
            fn = jax.jit(one)
            got = [fn(xr, prev, nxt, c) for c in cand]
            outs = [np.stack([np.asarray(g[k]) for g in got])
                    for k in range(3)]
        elif form == "K":
            outs = jax.jit(one)(xr, prev, nxt, cand)
        else:
            axes = (0, 0, 0, 0 if form == "BK" else None)
            outs = jax.jit(jax.vmap(one, in_axes=axes))(xr, prev, nxt, cand)
        for name, v in zip(("cells", "ystart", "span"), outs):
            res[f"{_case_id(case)}/{name}"] = np.asarray(v)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def strict(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_segment_cells") / "strict.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=STRICT_XLA_FLAGS)
    log = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert log.returncode == 0, log.stdout + log.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


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


def _tinputs(case, device="cpu"):
    """``_inputs`` as torch tensors on ``device``: the ``TK`` candidates
    one row expanded over the partitions (stride 0), as the partitioned
    ranking passes them."""
    xr, prev, nxt, cand = (torch.from_numpy(np.array(a)).to(device)
                           for a in _inputs(case))
    if case[3] == "TK":
        cand = cand.expand(PARTS, -1)
    return xr, prev, nxt, cand


def _outputs(fn, case, device="cpu"):
    """``fn(xr, prev, nxt, i, W, kappa)``'s (cells, ystart, span) on
    ``case``, 0-d candidates one call each, stacked."""
    _, kap, W, form = case
    xr, prev, nxt, cand = _tinputs(case, device)
    if form == "0d":
        got = [fn(xr, prev, nxt, c, W, kap) for c in cand]
        return tuple(torch.stack([g[k] for g in got]) for k in range(3))
    return fn(xr, prev, nxt, cand, W, kap)


def _bits(a) -> np.ndarray:
    a = np.asarray(a.cpu().numpy() if torch.is_tensor(a) else a)
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize]) \
        if a.dtype.kind == "f" else a


def _assert_same(got, want):
    for g, w in zip(got, want):
        g = g.cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dt", ("float32", "float64"))
@pytest.mark.parametrize("W", (8, 64))
def test_geometry_is_segment_fma_windows(dt, W):
    """Lane 0 before its stretch is removed is ``_windows``' case: the
    same reconstruction, and the port's neighbours of its mask equal the
    reference's."""
    from test_torch_segment_fma import _windows
    xr, prev, nxt, cand = _windows(dt, W)
    mine, alive = _windows_draw(dt, W, 0)
    np.testing.assert_array_equal(_bits(mine), _bits(xr))
    got = alive_neighbors(torch.from_numpy(alive))
    np.testing.assert_array_equal(got[0].numpy(), prev)
    np.testing.assert_array_equal(got[1].numpy(), nxt)
    np.testing.assert_array_equal(np.nonzero(alive[1:-1])[0] + 1, cand)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_equals_strict_reference(strict, case):
    """The plain version's cells, ystart and span are strict JAX's bits;
    the cases hold spans past W and the endpoints."""
    got = _outputs(seg.segment_cells_plain, case)
    want = [strict[f"{_case_id(case)}/{k}"] for k in ("cells", "ystart",
                                                      "span")]
    _assert_same(got, want)
    assert int(want[2].max()) > case[2] and int(want[2].min()) >= 0


def _layout(W: int) -> tuple:
    """``(warps a block, G)`` as ``csrc/segment_cells.cu`` states them:
    ``kWarps``, and ``group_log``'s G, the least power of two from 2^lo to
    2^hi with 4 G >= W, read from the source so that the rule is stated
    once."""
    import re
    src = open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                            "segment_cells.cu")).read()
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    lo, hi, per = map(int, re.search(
        r"int lg = (\d+);\s*while \(lg < (\d+) && \((\d+) << lg\) < W\) "
        r"\+\+lg;", src).groups())
    lg = lo
    while lg < hi and (per << lg) < W:
        lg += 1
    return warps, 1 << lg


def _kernel_model(xr, prev, nxt, i, W: int, kappa: int):
    """``csrc/segment_cells.cu``'s schedule on the CPU, over the flat
    buffers the wrapper passes (``seg._lanes``): a group of G lanes a
    window and a block of ``kWarps`` warps (``_layout``), 32 / G windows a
    warp, the last warp's groups past the windows idle; lane 0 of a group
    wraps the candidate once, clamps it and loads p and q; lane g forms
    the terms j = g, g + G, ... each from its own operands and the
    endpoint values (the FMA rounded once); at kappa > 1 a block's
    windows staged, then its (window, cell) pairs spread over its
    threads, each chained over [c kappa - off, c kappa - off + kappa)
    within [0, W) from +0, then divided once."""
    i, rows, k_, stride, lead = seg._lanes(xr, torch.as_tensor(i))
    n = xr.shape[-1]
    dt = xr.numpy().dtype.type
    X = xr.reshape(-1).numpy()
    P, Q = prev.reshape(-1).numpy(), nxt.reshape(-1).numpy()
    C = i.reshape(-1).numpy()
    Wy = W // kappa + 2 if kappa > 1 else W
    cells = np.empty((rows * k_, Wy), dtype=dt)
    ystart = np.empty(rows * k_, dtype=np.int32)
    span = np.empty(rows * k_, dtype=np.int32)
    warps, G = _layout(W)
    per_block = warps * (32 // G)
    windows = rows * k_
    stage = np.zeros((per_block, W), dtype=dt)
    starts = np.zeros(per_block, dtype=np.int64)
    for w in range(-(-windows // per_block) * per_block):
        mine = w % per_block
        if w < windows:
            r, k = divmod(w, k_)
            starts[mine] = _group_terms(X, P, Q, C, r, k, stride, n, W, G,
                                        stage[mine], cells, ystart, span, w,
                                        kappa)
        if kappa == 1 or mine < per_block - 1:
            continue
        # the block's cells: task t of its threads is (window t // Wy,
        # cell t % Wy); the last block's idle windows end a thread's tasks
        base = w - mine
        for thread in range(32 * warps):
            for t in range(thread, per_block * Wy, 32 * warps):
                s, c = divmod(t, Wy)
                if base + s >= windows:
                    break
                off = starts[s] - (starts[s] // kappa) * kappa
                j0 = c * kappa - off
                j1 = min(j0 + kappa, W)
                acc = dt(0)
                for j in range(max(j0, 0), j1):
                    acc = acc + stage[s, j]
                cells[base + s, c] = acc / dt(kappa)
    return (torch.from_numpy(cells.reshape(lead + (Wy,))),
            torch.from_numpy(ystart.reshape(lead)),
            torch.from_numpy(span.reshape(lead)))


def _group_terms(X, P, Q, C, r, k, stride, n, W, G, stage, cells, ystart,
                 span, w, kappa):
    """One group's window: lane 0's loads, lane g's terms j = g, g + G,
    ... into ``stage`` (and ``cells`` at kappa 1), ystart and span; returns
    the window's start."""
    dt = X.dtype.type
    ii = int(C[r * stride + k])
    ii = ii + n if ii < 0 else ii
    ic = min(max(ii, 0), n - 1)
    p, q = int(P[r * n + ic]), int(Q[r * n + ic])
    pc, qc = min(max(p, 0), n - 1), min(max(q, 0), n - 1)
    xp, xq = X[r * n + pc], X[r * n + qc]
    start, sp = p + 1, q - p - 1
    dq = xq - xp
    denom = max(dt(q - p), dt(1))
    tdt = torch.from_numpy(X[:1]).dtype
    for g in range(G):
        j = np.arange(g, W, G)
        if not j.size:
            continue
        absj = np.clip(start + j, 0, n - 1)
        t = (absj - pc).astype(dt) / denom
        v = fma_rn(torch.full(j.shape, float(dq), dtype=tdt),
                   torch.from_numpy(t),
                   torch.full(j.shape, float(xp), dtype=tdt)).numpy()
        stage[j] = (v - X[r * n + absj]) * (j < sp).astype(dt)
    if kappa == 1:
        cells[w] = stage
    ystart[w] = start // kappa if kappa > 1 else start
    span[w] = sp
    return start


@pytest.mark.parametrize("case", [c for c in CASES if c[3] != "0d"],
                         ids=_case_id)
def test_kernel_model_equals_plain(case):
    """The kernel's schedule gives the plain version's bits: its lane
    layout (one row for every lane at ``TK``), the candidate rule, the
    cells' ranges and ystart's floor."""
    got = _outputs(_kernel_model, case)
    want = _outputs(seg.segment_cells_plain, case)
    _assert_same(got, [w.numpy() for w in want])


@pytest.mark.parametrize("kap", (1, 48))
def test_ops_segment_cells_takes_the_plain_version_on_the_cpu(kap):
    """``ops.segment_cells`` and the wrapper take the plain version for CPU
    tensors (no launch counted); ``x_window=True`` appends the x-space
    window and its start, ``segment_deltas``' own."""
    from repro_torch.core.aggregates import segment_deltas
    case = ("float64", kap, 64, "BK")
    xr, prev, nxt, cand = _tinputs(case)
    cfg = tc.CameoConfig(kappa=kap)
    before = seg.segment_cells_cuda.launches
    got = tops.segment_cells(cfg, xr, prev, nxt, cand, 64, x_window=True)
    assert seg.segment_cells_cuda.launches == before
    want = seg.segment_cells_plain(xr, prev, nxt, cand, 64, kap)
    wrapped = seg.segment_cells_cuda(xr, prev, nxt, cand, 64, kap)
    dwin, start, span = segment_deltas(xr, prev, nxt, cand, 64)
    _assert_same(got, [t.numpy() for t in want + (dwin, start)])
    _assert_same(wrapped, [t.numpy() for t in want])
    _assert_same(got[2:3], [span.numpy()])


def _counting(monkeypatch):
    """Dispatch every path as on the card (the wrappers take their plain
    versions for CPU tensors) and count ``segment_cells``' wrapper calls
    by their candidates' shapes."""
    calls = []
    wrapper = seg.segment_cells_cuda

    def counting(*a, **kw):
        calls.append(tuple(torch.as_tensor(a[3]).shape))
        return wrapper(*a, **kw)
    monkeypatch.setattr(tops, "segment_cells_cuda", counting)
    monkeypatch.setattr(tops, "resolve_backend",
                        lambda backend, device=None: "cuda")
    monkeypatch.setattr(tops, "x_window_to_y", None)
    return calls


@pytest.mark.parametrize("path", ("rounds", "scan", "sequential",
                                  "partitioned"))
def test_every_path_takes_segment_cells(monkeypatch, path):
    """Each path's Eq. 9 windows come from ``segment_cells`` (and none
    through ``x_window_to_y``): the rounds' tiers (``[1, K]``), the scan's
    prefix windows, the sequential trial (0-d) and ReHeap (``[P]``), the
    partitioned ranking (``[T, K]``); at aus_elec's kappa 48."""
    calls = _counting(monkeypatch)
    x = make_dataset("aus_elec", seed=0, length=48 * 48)
    # a partition holds L + W target points: W 16 at two partitions
    over = dict(rounds={}, scan=dict(select="scan"),
                sequential=dict(mode="sequential", hops=4, max_iters=6),
                partitioned=dict(max_rounds=2, window=16))[path]
    cfg = tc.CameoConfig(eps=1e-2, kappa=48, lags=7, **over)
    if path == "partitioned":
        tpar.compress_partitioned(x, cfg, 2, device="cpu")
    else:
        tc.compress(x, cfg, device="cpu")
    ranks = {len(s) for s in calls}
    want = {"rounds": {2}, "scan": {2}, "sequential": {0, 1},
            "partitioned": {2}}[path]
    assert calls and ranks == want


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_equals_plain_on_card(cuda, case):
    """On the card one launch gives the plain version's bits (on the card
    and on the CPU), the x-space window too."""
    _, kap, W, form = case
    before = seg.segment_cells_cuda.launches
    got = _outputs(seg.segment_cells_cuda, case, cuda)
    assert seg.segment_cells_cuda.launches == before + (
        K if form == "0d" else 1)
    want = _outputs(seg.segment_cells_plain, case, cuda)
    _assert_same(got, [w.cpu().numpy() for w in want])
    _assert_same(got, [w.numpy() for w in _outputs(
        seg.segment_cells_plain, case)])
    if form != "0d":
        args = _tinputs(case, cuda) + (W, kap)
        _assert_same(seg.segment_cells_cuda(*args, x_window=True)[3:],
                     [w.cpu().numpy() for w in seg.segment_cells_plain(
                         *args, x_window=True)[3:]])


@pytest.mark.gpu
def test_kernel_refuses_other_types_on_card(cuda):
    xr, prev, nxt, cand = _tinputs(("float64", 1, 8, "K"), cuda)
    with pytest.raises(TypeError):
        seg.segment_cells_cuda(xr.half(), prev, nxt, cand, 8, 1)
    with pytest.raises(TypeError):
        seg.segment_cells_cuda(xr, prev.long(), nxt, cand, 8, 1)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
