"""llama-3.2-vision-90b [vlm; hf:meta-llama/Llama-3.2-90B-Vision]:
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th
layer is a gated cross-attention layer over image tokens (20 total).
Vision frontend is a stub: callers pass patch embeddings
[B, 1600, d_model] (``batch["image_embeds"]``)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vision",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    cross_attn_every=5, cross_attn_offset=4, n_image_tokens=1600,
    act="swiglu", norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, n_image_tokens=16)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE,
                skip_shapes={"long_500k": FULL_ATTENTION_SKIP})
