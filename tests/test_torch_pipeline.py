"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's, on the CPU: the tokenizer's codes and decoded values, the
windows and the forecasting batches bit-equal to the reference's (the
same numpy arithmetic); ``token_batch`` deterministic in (seed, step), in
range and with the vision stub's patch embeddings (its draws are torch's,
not ``jax.random``'s, so only their form is held to the reference's)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic import make_dataset

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


@pytest.mark.parametrize("vocab", (256, 2048))
def test_tokenizer_matches_reference(vocab):
    x = make_dataset("uk_elec", seed=0, length=4096)
    noisy = x + np.random.default_rng(1).normal(0, 0.05 * x.std(), x.shape)
    jt = jpipe.SeriesTokenizer.fit(x, vocab)
    tt = tpipe.SeriesTokenizer.fit(x, vocab)
    assert (tt.lo, tt.hi, tt.vocab) == (jt.lo, jt.hi, jt.vocab)
    codes = tt.encode(noisy)
    assert codes.dtype == np.int32
    np.testing.assert_array_equal(codes, jt.encode(noisy))
    assert codes.min() >= 0 and codes.max() <= vocab - 1
    np.testing.assert_array_equal(tt.decode(codes), jt.decode(codes))
    flat = tpipe.SeriesTokenizer.fit(np.full(5, 3.0), vocab)
    assert flat.hi == flat.lo + 1.0


@pytest.mark.parametrize("window,stride", ((1024, 256), (32, 16), (7, 7)))
def test_windows_and_batches_match_reference(window, stride):
    toks = tpipe.SeriesTokenizer.fit(
        make_dataset("uk_elec", seed=0, length=17520), 2048).encode(
            make_dataset("uk_elec", seed=0, length=17520))
    w = tpipe.series_windows(toks, window, stride)
    np.testing.assert_array_equal(w, jpipe.series_windows(toks, window,
                                                          stride))
    if (window, stride) == (1024, 256):
        assert w.shape == (65, 1024)
    for step in (0, 1, 7):
        got = tpipe.forecast_batches(w, 8, step, seed=3, device="cpu")
        want = jpipe.forecast_batches(w, 8, step, seed=3)
        assert got["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))


@pytest.mark.parametrize("arch", ("musicgen-large", "qwen2-vl-2b"))
def test_token_batch_deterministic_and_in_range(arch):
    cfg = treg.get_reduced(arch)
    a = tpipe.token_batch(cfg, 3, 16, step=5, seed=2, device="cpu")
    b = tpipe.token_batch(cfg, 3, 16, step=5, seed=2, device="cpu")
    c = tpipe.token_batch(cfg, 3, 16, step=6, seed=2, device="cpu")
    d = tpipe.token_batch(cfg, 3, 16, step=5, seed=3, device="cpu")
    ref = jpipe.token_batch(jreg.get_reduced(arch), 3, 16, step=5, seed=2)
    assert set(a) == set(ref)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert tuple(a[k].shape) == ref[k].shape
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert int(a["tokens"].min()) >= 0
    assert int(a["tokens"].max()) < cfg.vocab
    if "patch_embeds" in a:
        pe = a["patch_embeds"]
        assert pe.dtype == torch.float32 and ref["patch_embeds"].dtype == \
            jnp.float32
        assert 0.01 < float(pe.std()) < 0.03


def test_token_batch_stable_across_processes():
    """crc32-seeded: another process draws the same batch (the reference's
    ``hash``-free ``fold_in`` is stable too; the port's seed is crc32)."""
    code = (f"import sys; sys.path.insert(0, {SRC!r});"
            "from repro_torch.configs import registry as r;"
            "from repro_torch.data import pipeline as p;"
            "t = p.token_batch(r.get_reduced('smollm-135m'), 2, 8, 4, 1, "
            "'cpu')['tokens'];"
            "print(t.flatten().tolist())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    here = tpipe.token_batch(treg.get_reduced("smollm-135m"), 2, 8, 4, 1,
                             "cpu")["tokens"]
    assert out.strip() == str(here.flatten().tolist())


def test_pipeline_defaults_to_the_card():
    """``token_batch`` and ``forecast_batches`` put their tensors on the card
    unless the caller asks for the CPU; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = treg.get_reduced("musicgen-large")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.token_batch(cfg, 2, 8, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.forecast_batches(np.zeros((4, 8), np.int32), 2, 0)
