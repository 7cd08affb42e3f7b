"""stablelm-12b [dense; hf:stabilityai/stablelm-2-12b]: 40L
d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352 (head_dim=160)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="decoder",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
    act="swiglu", norm="layernorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE,
                skip_shapes={"long_500k": FULL_ATTENTION_SKIP})
