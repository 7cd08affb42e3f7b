"""`repro_torch.ft` — fault tolerance: injection and the crash harness.

- :mod:`repro_torch.ft.inject` — deterministic fault injection behind
  named ``fault_site`` hooks threaded through the durability-critical
  writes and reads (checkpoint commits, engine commits, artifact
  save/load, the repair merge, the serve answer path), plus the
  bounded-retry wrapper those paths use for transient I/O;
- :mod:`repro_torch.ft.harness` — drives real subprocesses through
  crash plans and asserts that recovery lands bit-identical labels.

Node loss and re-meshing (the reference's ``ft/elastic.py``) go with
the distributed port (ROADMAP Queue 1, item 11).
"""

from repro_torch.ft.inject import (ENV_PLAN, FAULT_EXIT_CODE, FAULT_KINDS,
                                   KNOWN_SITES, Fault, FaultPlan,
                                   InjectedCrash, TransientIOError,
                                   fault_site, faults, flip_bits, install,
                                   torn_write, with_retries)

__all__ = [
    "ENV_PLAN", "FAULT_EXIT_CODE", "FAULT_KINDS", "KNOWN_SITES", "Fault",
    "FaultPlan", "InjectedCrash", "TransientIOError", "fault_site",
    "faults", "flip_bits", "install", "torn_write", "with_retries",
]
