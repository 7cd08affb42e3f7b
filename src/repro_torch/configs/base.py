"""Architecture registry: the ten LM configurations (full size and a
reduced smoke twin each), the shape cells they are sized against, and
which cells an architecture skips by design."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

FULL_ATTENTION_SKIP = ("full attention is quadratic at 512k; skipped "
                       "per assignment (sub-quadratic archs only)")


class SkipCell(Exception):
    """Raised when an (arch × shape) cell is skipped by design."""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke: ModelConfig
    skip_shapes: Dict[str, str]    # shape name → reason

    def skip_reason(self, shape: str) -> Optional[str]:
        return self.skip_shapes.get(shape)


ARCH_IDS = (
    "whisper_base",
    "qwen3_moe_235b_a22b",
    "dbrx_132b",
    "stablelm_1_6b",
    "stablelm_12b",
    "yi_34b",
    "smollm_360m",
    "llama32_vision_90b",
    "xlstm_125m",
    "jamba15_large_398b",
    # the paper's own workload (CHL construction) as a config
    "chl_road",
    "chl_scalefree",
)

_LM_ARCHS = ARCH_IDS[:10]


def lm_arch_ids():
    return _LM_ARCHS


def get(name: str) -> Optional[ArchSpec]:
    """The `ArchSpec` of ``name`` (dashes and dots read as
    underscores); ``None`` for the CHL configurations, which are not
    LM architectures."""
    name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SPEC
