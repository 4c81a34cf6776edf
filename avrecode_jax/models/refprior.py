"""Model families: prior-model configurations of the recompression engine.

The framework ships one family, `refprior` — the reference-parity adaptive
prior model (SURVEY.md §2.5) extended with the improvements measured in this
repo: per-slice-class estimator banks, dual-speed counting estimators, a
mirrored-CABAC prior bank, temporal/spatial nonzero priors, the hypergeometric
significance prior, TRI-modal significance coding (NZ-first / adaptive-EOB /
CABAC-parity-EOB, chosen per (slice_class, cat) cell from pass-1 stats), and
3-bit Markov history in the off-mode significance keys. The C++ implementation
lives in native/model.h; the device implementations in ops/model_pass.py
consume the exported key streams.

These values are *format-defining*. The single source of truth is the C++
(native/model.h constants, serialized into every analysis export header);
this module states them for Python consumers and documentation, and
tests/test_device_model.py::test_refprior_constants_match_native asserts the
three layers agree so this file cannot rot.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RefPriorConfig:
    name: str = "refprior"
    # estimator windows (observations before halving) — model.h kFastWindow /
    # kSlowWindow / kWindowSig
    fast_window: int = 48
    slow_window: int = 640
    sig_window: int = 128         # reference used 0x50 (recode.cpp:1042);
                                  # 128 measured better with the mirror prior
    # significance prior mixing — model.h kSigMixAlpha / kSigMixAlphaOff;
    # the off-mode tag travels in prior bit 15 (kPriorOffTag)
    sig_mix_alpha: int = 1        # on-mode: hypergeometric prior weight
    sig_mix_alpha_off: int = 48   # off-mode default (probe may override)
    # v18: the off weight is chosen per file by the nz-mode probe from these
    # candidates (model.h kSigAlphaCands) and travels in the container and
    # the analyze header's sig_alpha high half.
    sig_mix_alpha_off_cands: tuple = (48, 32, 64, 96)
    sig_hash_bits: int = 17       # sig key space hashed to 2^17 entries
    # v15 residual-level mix — model.h kResDirAlpha / kResDirFastBoost /
    # ops.model_pass.RES_DIR_ALPHA / RES_DIR_K; selected per bin by the
    # prior's bit-15 tag on kKindDual bins
    res_dir_alpha: int = 32
    res_dir_fast_boost: int = 2
    # model profiles (container field): 0 = immediate within-batch increments
    # (host path, ratio-optimal), 2 = frozen-batch (device path, slim wire,
    # measured +0.10pp on bench.mp4). Profile 1 (EMA) was removed in favour
    # of the XLA super-batched pass.
    profiles: tuple = (0, 2)
    # batched-update semantics (the device formulation)
    default_batch: int = 4096
    max_batch: int = 32768        # uint16 counter headroom
    # entropy lanes
    prob_bits: int = 15
    default_lanes: int = 16
    max_lanes: int = 1024


MODEL_FAMILIES = {
    "refprior": RefPriorConfig(),
}
