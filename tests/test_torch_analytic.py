"""The port's analytic per-step model (``repro_torch.launch.analytic``)
against the JAX package's, on the CPU.

``step_flops`` and ``step_hbm_bytes`` equal the reference's with ``==``
(the same arithmetic in the same order) for every config, full width and
reduced, every shape in ``SHAPES``, chips in {1, 4, 256, 512} and
``model_par`` in {1, 8, 16}; so do ``model_flops_per_token`` and the
parameter bytes they read.
"""
import pytest

from repro.configs import registry as jreg
from repro.launch import analytic as ja
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.launch import analytic as ta

CHIPS = (1, 4, 256, 512)
MODEL_PAR = (1, 8, 16)


def _cfgs(arch, reduced):
    if reduced:
        return jreg.get_reduced(arch), treg.get_reduced(arch)
    return jreg.get_config(arch), treg.get_config(arch)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_step_model_equals_reference(arch, shape_name, reduced):
    jc, tc = _cfgs(arch, reduced)
    assert ta.step_flops(tc, shape_name) == ja.step_flops(jc, shape_name)
    for chips in CHIPS:
        for mp in MODEL_PAR:
            assert ta.step_hbm_bytes(tc, shape_name, chips, mp) == \
                ja.step_hbm_bytes(jc, shape_name, chips, mp), (chips, mp)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_per_token_flops_and_param_bytes_equal_reference(arch):
    jc, tc = _cfgs(arch, False)
    for s_kv in (1.0, 2048.0, 16384.0):
        for decode in (False, True):
            assert ta.model_flops_per_token(tc, s_kv, decode) == \
                ja.model_flops_per_token(jc, s_kv, decode)
    assert ta._param_bytes(tc) == ja._param_bytes(jc)
    assert ta._active_param_bytes(tc) == ja._active_param_bytes(jc)
