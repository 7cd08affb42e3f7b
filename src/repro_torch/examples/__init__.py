"""Runnable end-to-end examples of the port, each ``python -m
repro_torch.examples.<name>`` on the card (``main(device="cpu")`` runs
the plain PyTorch path):

- :mod:`quickstart` — build, validate against Dijkstra, serve, and
  round-trip the artifact through every store;
- :mod:`dynamic_repair` — mutate under a live index, repair, keep
  serving; repair equals a rebuild bit for bit;
- :mod:`serve_chl_queries` — the hybrid on 8 logical nodes and the
  serving tier in qlsn, qfdl and qdol;
- :mod:`elastic_failover` — a node lost mid-build, its roots re-planted
  on the survivors, the labeling still the CHL.
"""
