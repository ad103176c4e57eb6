"""Baselines from the paper's evaluation (§5.1; port of
``repro/baselines``), all adapted to report or enforce the ACF-deviation
constraint:

* line simplification: VW, TPs, TPm, PIPv, PIPe  (removal engine with exact
  incremental ACF constraint checks — the paper's own adaptation strategy)
* functional approximation: PMC, SWING, Sim-Piece (trial-and-error search of
  the value error bound that meets the ACF bound, as in the paper)
* domain transform: FFT (top-m coefficients, binary search on m)
* lossless: Gorilla, Chimp (bits-per-value cost models for Table 2)
"""
from repro_torch.baselines.line_simpl import (
    constrained_removal, vw_rank, tp_rank_s, tp_rank_m, pip_rank_v, pip_rank_e,
    LINE_SIMPL_BASELINES,
)
from repro_torch.baselines.functional import (pmc_compress, swing_compress,
                                              simpiece_compress)
from repro_torch.baselines.transform import fft_compress
from repro_torch.baselines.constrain import acf_constrained_search
from repro_torch.baselines.lossless import (gorilla_bits_per_value,
                                            chimp_bits_per_value)
