"""`BuildPlan` — one frozen, validated build configuration.

A copy of the reference package's plan, field for field, so that
``to_dict()`` and the on-disk manifest match. Every algorithm and store
name the reference accepts validates here, and the port builds every
algorithm.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.index.quant.codecs import DIST_CODECS

ALGOS = ("plant", "gll", "lcc", "parapll", "dgll", "hybrid",
         "plant-dist", "directed", "pll-ref")

#: algorithms that run on a node mesh (superstep driver, §5)
DISTRIBUTED_ALGOS = ("dgll", "hybrid", "plant-dist")

#: store kinds a plan may request ("spill" is a load-time residency)
BUILD_STORE_KINDS = ("dense", "sharded", "compressed")


@dataclasses.dataclass(frozen=True)
class BuildPlan:
    """Frozen build configuration for ``repro_torch.index.build``.

    ``cap=None`` -> ``labels.default_cap(n)`` at build time. On label
    table overflow the build retries with the cap grown by
    ``cap_growth`` (clamped to n), at most ``max_cap_retries`` times.
    """

    algo: str = "hybrid"
    batch: int = 8
    cap: Optional[int] = None
    beta: float = 8.0                 # superstep growth (§5.1)
    first_superstep: int = 1          # initial superstep size (roots)
    eta: int = 16                     # common-label-table hubs (§5.3)
    hc_cap: int = 64
    psi_th: Optional[float] = None    # PLaNT->DGLL switch (§5.2.1)
    alpha: Optional[float] = 4.0      # GLL cleaning threshold (§4.2)
    compact: int = 0                  # compact broadcast budget
    mesh_devices: Optional[int] = None
    max_cap_retries: int = 4
    cap_growth: float = 2.0
    store: str = "dense"              # label residency
    shards: Optional[int] = None      # hub partitions for store="sharded"
    codec: Optional[str] = None       # distance codec for store="compressed"
    quant_exact: bool = False         # validated exactness mode (quant)

    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ValueError(f"algo {self.algo!r} not one of {ALGOS}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.cap is not None and self.cap < 1:
            raise ValueError(f"cap must be >= 1, got {self.cap}")
        if self.beta <= 1.0:
            raise ValueError(f"beta must be > 1, got {self.beta}")
        if self.first_superstep < 1:
            raise ValueError(f"first_superstep must be >= 1, got "
                             f"{self.first_superstep}")
        if self.eta < 0 or self.hc_cap < 1:
            raise ValueError("eta must be >= 0 and hc_cap >= 1")
        if self.psi_th is not None and self.psi_th < 0:
            raise ValueError(f"psi_th must be >= 0, got {self.psi_th}")
        if self.compact < 0:
            raise ValueError(f"compact must be >= 0, got {self.compact}")
        if self.mesh_devices is not None and self.mesh_devices < 1:
            raise ValueError("mesh_devices must be >= 1")
        if self.max_cap_retries < 0 or self.cap_growth <= 1.0:
            raise ValueError(
                "max_cap_retries must be >= 0 and cap_growth > 1")
        if self.store not in BUILD_STORE_KINDS:
            raise ValueError(
                f"store {self.store!r} not one of {BUILD_STORE_KINDS} "
                "(\"spill\" is a load/serve-time residency)")
        if self.shards is not None and self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.codec is not None and self.codec not in DIST_CODECS:
            raise ValueError(
                f"codec {self.codec!r} not one of {DIST_CODECS}")
        if self.store != "compressed" and (self.codec is not None
                                           or self.quant_exact):
            raise ValueError(
                "codec / quant_exact apply only to store='compressed'")

    @property
    def distributed(self) -> bool:
        return self.algo in DISTRIBUTED_ALGOS

    @classmethod
    def from_args(cls, args, **overrides) -> "BuildPlan":
        """Plan from an argparse ``Namespace``: every field the
        namespace carries (and is not None) is read, the rest keep
        their defaults; ``overrides`` win."""
        kw = {f.name: getattr(args, f.name)
              for f in dataclasses.fields(cls)
              if getattr(args, f.name, None) is not None}
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_dict(cls, d: dict) -> "BuildPlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown BuildPlan keys: {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
