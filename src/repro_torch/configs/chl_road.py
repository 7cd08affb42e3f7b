"""CHL on a road-network-scale graph (CTR/USA regime: n ~ 16M, deg <= 8,
high diameter). The paper's sweet spot for pure PLaNT (§7.3)."""

from repro_torch.configs.chl_common import ChlConfig

CONFIG = ChlConfig(name="chl-road", n=16_777_216, max_deg=8,
                   batch=4, trees_per_node=8, cap=8, hc_cap=32)

SMOKE = ChlConfig(name="chl-road-smoke", n=1024, max_deg=8,
                  batch=2, trees_per_node=4, cap=16, hc_cap=16)

SPEC = None   # not an LM architecture: base.get() returns None for it
