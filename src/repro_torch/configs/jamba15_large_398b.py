"""jamba-1.5-large-398b [hybrid; arXiv:2403.19887]: 72L d_model=8192
64H (GQA kv=8) d_ff=24576 vocab=65536; Mamba:attention 7:1 (layer 3 of
each 8-block is attention), MoE 16 experts top-2 on every other layer.
Mamba state decode + KV only on 9 attention layers → long_500k RUNS."""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    moe_experts=16, moe_topk=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=3,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    act="swiglu", norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, moe_experts=4, moe_topk=2, ssm_chunk=8)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE, skip_shapes={})
