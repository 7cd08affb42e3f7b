"""smollm-360m [dense; hf:HuggingFaceTB/SmolLM-360M]: 32L d_model=960
15H (GQA kv=5) d_ff=2560 vocab=49152, head_dim 64; 409,007,040
parameters."""

import dataclasses

from repro_torch.configs.base import ArchSpec, FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="decoder",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152,
    act="swiglu", norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=60, n_heads=3, n_kv_heads=1,
    d_ff=128, vocab=256)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE,
                skip_shapes={"long_500k": FULL_ATTENTION_SKIP})
