"""yi-34b [dense; arXiv:2403.04652]: 60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000 — llama-architecture GQA decoder."""

import dataclasses

from repro_torch.configs.base import ArchSpec, FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="decoder",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    act="swiglu", norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE,
                skip_shapes={"long_500k": FULL_ATTENTION_SKIP})
