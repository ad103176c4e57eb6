"""The port's serving engine and launcher (``repro_torch.serving.engine``,
``repro_torch.launch.serve``) against the JAX package's, on the CPU.

Greedy tokens equal JAX's ``Engine`` for smollm-135m, qwen3-0.6b and the
MoE, Mamba2 and hybrid archs reduced (float32, the reference's weights
carried across), EOS included;
identical prompts give identical rows; sampled generation is deterministic
for a seed and in range (its draws are torch's, not ``jax.random``'s, so
they are not compared with the reference's); the launcher runs tiny on the
CPU, and refuses the card where there is none.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as jget
from repro.models.model import model_defs as jdefs
from repro.models.params import init_params as jinit
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch.configs.registry import get_reduced as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.serving.engine import Engine, ServeConfig

NEW = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread, as the other port test files run it
    (ROADMAP C6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(arch, **scfg):
    """(port engine, JAX engine, vocab) over the same weights."""
    jcfg = jget(arch)
    jp = jinit(jdefs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tget(arch), "cpu")
    port = Engine(tget(arch), tp, ServeConfig(max_new_tokens=NEW, **scfg),
                  device="cpu")
    ref = JEngine(jcfg, jp, JServeConfig(max_new_tokens=NEW, **scfg))
    return port, ref, jcfg.vocab


def _prompts(vocab, B=3, S=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ("smollm-135m", "qwen3-0.6b",
                                  "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
                                  "mamba2-2.7b", "jamba-1.5-large-398b"))
def test_greedy_tokens_equal_reference(arch):
    port, ref, vocab = _pair(arch)
    prompts = _prompts(vocab)
    got = port.generate(prompts)
    assert got.shape == (3, NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.generate(prompts))
    np.testing.assert_array_equal(port.generate(prompts), got)
    assert port.stats["decode_steps"] == NEW
    assert port.stats["prefill_s"] > 0 and port.stats["decode_s"] > 0


def test_eos_stops_as_reference():
    """EOS set to a token row 0 emits at its third step: row 0 stops there
    and is EOS-padded, the others go on; equal to the reference's rows."""
    port, ref, vocab = _pair("smollm-135m")
    prompts = _prompts(vocab, seed=1)
    eos = int(port.generate(prompts)[0, 2])
    port, ref, _ = _pair("smollm-135m", eos_id=eos)
    got = port.generate(prompts)
    np.testing.assert_array_equal(got, ref.generate(prompts))
    assert (got[0, 2:] == eos).all()


def test_eos_all_done_breaks_early():
    port, ref, vocab = _pair("qwen3-0.6b")
    prompts = np.tile(_prompts(vocab, B=1, seed=2), (2, 1))
    eos = int(port.generate(prompts)[0, 0])
    port, ref, _ = _pair("qwen3-0.6b", eos_id=eos)
    got = port.generate(prompts)
    assert (got == eos).all()
    assert port.stats["decode_steps"] == 0
    np.testing.assert_array_equal(got, ref.generate(prompts))


def test_identical_prompts_identical_outputs():
    port, _, vocab = _pair("smollm-135m")
    prompts = np.tile(np.arange(12, dtype=np.int32) % vocab, (4, 1))
    out = port.generate(prompts)
    for i in range(1, 4):
        np.testing.assert_array_equal(out[0], out[i])


def test_sampled_generation_deterministic_for_seed():
    cfg = tget("smollm-135m")
    _, _, vocab = _pair("smollm-135m")
    port, _, _ = _pair("smollm-135m", temperature=0.8, seed=3)
    prompts = _prompts(vocab, B=2, S=10)
    out = port.generate(prompts)
    assert out.shape == (2, NEW)
    assert (out >= 0).all() and (out < cfg.vocab).all()
    np.testing.assert_array_equal(port.generate(prompts), out)
    again, _, _ = _pair("smollm-135m", temperature=0.8, seed=3)
    np.testing.assert_array_equal(again.generate(prompts), out)


def test_engine_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs its absence")
    port, _, _ = _pair("smollm-135m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(port.cfg, port.params, port.scfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m"])


def test_launcher_runs_tiny_on_cpu(capsys):
    out = serve.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "12", "--new-tokens", "3"])
    assert out["device"] == "cpu" and out["tokens"].shape == (2, 3)
    assert "qwen3-0.6b-reduced on cpu" in capsys.readouterr().out
    again = serve.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--batch",
                        "2", "--prompt-len", "12", "--new-tokens", "3"])
    np.testing.assert_array_equal(again["tokens"], out["tokens"])


@pytest.mark.parametrize("arch", ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
                                  "mamba2-2.7b", "jamba-1.5-large-398b"))
def test_launcher_serves_the_moe_and_mamba_families(arch, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "12", "--new-tokens", "3"])
    assert out["tokens"].shape == (2, 3)
    assert f"{arch}-reduced on cpu" in capsys.readouterr().out
