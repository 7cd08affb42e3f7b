"""xlstm-125m [ssm; arXiv:2405.04517]: 12L d_model=768 4H d_ff=0
vocab=50304 — sLSTM + mLSTM blocks (period 6: every 6th layer sLSTM,
rest mLSTM ≈ the paper's 7:1-style mix). Recurrent state decode →
long_500k RUNS for this arch (no KV cache)."""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_period=6, ssm_chunk=128,
    act="gelu", norm="layernorm", rope_theta=-1.0,  # no rope, no sinus
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
    vocab=256, ssm_chunk=8)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE, skip_shapes={})
