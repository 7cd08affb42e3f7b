"""CHL on a scale-free graph (LiveJournal regime: n ~ 4.8M); the Hybrid
path (PLaNT -> DGLL with common labels) is the representative workload.

The port lays such a graph out as a degree-capped pull ELL: at most
`repro_torch.graphs.graph.ELL_CAP` (128) columns, a hub's further
in-edges in a tail of arcs that every sweep route reads (the windowed
layout folds them into its segments, the plain sweep beside the ELL).
``max_deg`` here is the ELL width the dry run's closed forms take, not
the port's cap."""

from repro_torch.configs.chl_common import ChlConfig

CONFIG = ChlConfig(name="chl-scalefree", n=4_194_304, max_deg=64,
                   batch=4, trees_per_node=8, cap=32, hc_cap=64)

SMOKE = ChlConfig(name="chl-scalefree-smoke", n=512, max_deg=16,
                  batch=2, trees_per_node=4, cap=32, hc_cap=16)

SPEC = None   # not an LM architecture: base.get() returns None for it
