"""CHL on a scale-free graph (LiveJournal regime: n ~ 4.8M). ELL width
64 through degree-capped hub splitting; the Hybrid path (PLaNT -> DGLL
with common labels) is the representative workload."""

from repro_torch.configs.chl_common import ChlConfig

CONFIG = ChlConfig(name="chl-scalefree", n=4_194_304, max_deg=64,
                   batch=4, trees_per_node=8, cap=32, hc_cap=64)

SMOKE = ChlConfig(name="chl-scalefree-smoke", n=512, max_deg=16,
                  batch=2, trees_per_node=4, cap=32, hc_cap=16)
