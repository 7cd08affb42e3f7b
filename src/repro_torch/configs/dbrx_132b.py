"""dbrx-132b [moe; hf:databricks/dbrx-base]: 40L d_model=6144 48H
(GQA kv=8) d_ff=10752, vocab=100352, 16 experts top-4 (fine-grained)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="decoder",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    moe_experts=16, moe_topk=4,
    act="swiglu", norm="layernorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, moe_experts=4, moe_topk=2)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE,
                skip_shapes={"long_500k": FULL_ATTENTION_SKIP})
