"""Measured-cost selection among semantically equal MoE configs
(counterpart: tutel_tpu/autotune).

The reference's "parted" searches per-op sharding states with measured
costs; what the port keeps is the measured choice among the MoE layer's
equal per-call configs (adaptive_r, the all-to-all overlap degree,
megablocks narrowing, padded against ragged expert parallelism) and its
constructor variants (2DH, the all-to-all payload type).
"""

from .tuner import tune, tune_moe, moe_candidates, ConfigStore  # noqa: F401
