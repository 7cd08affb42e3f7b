"""stablelm-1.6b [dense; hf:stabilityai/stablelm-2-1_6b]: 24L
d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352. LayerNorm +
rotary + SwiGLU."""

import dataclasses

from repro_torch.configs.base import ArchSpec, FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="decoder",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352,
    act="swiglu", norm="layernorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE,
                skip_shapes={"long_500k": FULL_ATTENTION_SKIP})
