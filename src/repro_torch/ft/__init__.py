"""`repro_torch.ft` — fault tolerance: injection and the crash harness.

- :mod:`repro_torch.ft.inject` — deterministic fault injection behind
  named ``fault_site`` hooks threaded through the durability-critical
  writes and reads (checkpoint commits, engine commits, artifact
  save/load, the repair merge, the serve answer path), plus the
  bounded-retry wrapper those paths use for transient I/O;
- :mod:`repro_torch.ft.harness` — drives real subprocesses through
  crash plans and asserts that recovery lands bit-identical labels;
- :mod:`repro_torch.ft.elastic` — node loss and re-meshing: checkpoint
  restore onto another node mesh, lost-root collection for
  re-PLaNTing, and the host-side :class:`HeartbeatMonitor` failure
  detector wired into `repro_torch.engine.dist`.
"""

from repro_torch.ft.elastic import (HeartbeatMonitor, lost_roots,
                                    reshard_state, restore_elastic)
from repro_torch.ft.inject import (ENV_PLAN, FAULT_EXIT_CODE, FAULT_KINDS,
                                   KNOWN_SITES, Fault, FaultPlan,
                                   InjectedCrash, TransientIOError,
                                   fault_site, faults, flip_bits, install,
                                   torn_write, with_retries)

__all__ = [
    "ENV_PLAN", "FAULT_EXIT_CODE", "FAULT_KINDS", "KNOWN_SITES", "Fault",
    "FaultPlan", "HeartbeatMonitor", "InjectedCrash", "TransientIOError",
    "fault_site", "faults", "flip_bits", "install", "lost_roots",
    "reshard_state", "restore_elastic", "torn_write", "with_retries",
]
