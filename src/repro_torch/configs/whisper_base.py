"""whisper-base [audio; arXiv:2212.04356]: encoder-decoder transformer.

Assigned: 6L d_model=512 8H (MHA kv=8) d_ff=2048 vocab=51865.
Whisper-base is 6 encoder + 6 decoder layers; the conv audio frontend
is a stub: callers pass precomputed frame embeddings [B, 1500, 512]
(``batch["audio_embeds"]``). Absolute sinusoidal positions
(rope_theta=0), GELU, LayerNorm, pre-LN.
"""

import dataclasses

from repro_torch.configs.base import ArchSpec, FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=12, enc_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
    act="gelu", norm="layernorm", rope_theta=0.0,
    n_audio_tokens=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, enc_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, n_audio_tokens=24)

SPEC = ArchSpec(config=CONFIG, smoke=SMOKE,
                skip_shapes={"long_500k": FULL_ATTENTION_SKIP})
