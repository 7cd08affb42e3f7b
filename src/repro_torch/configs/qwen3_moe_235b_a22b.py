"""qwen3-moe-235b-a22b [moe; hf:Qwen/Qwen3-30B-A3B]: 94L d_model=4096
64H (GQA kv=4) per-expert d_ff=1536, vocab=151936, 128 experts top-8.
GQA with kv=4: each KV head serves 16 query heads."""

import dataclasses

from repro_torch.configs.base import ArchSpec, FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="decoder",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936,
    moe_experts=128, moe_topk=8,
    act="swiglu", norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, moe_experts=8, moe_topk=2)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE,
                skip_shapes={"long_500k": FULL_ATTENTION_SKIP})
