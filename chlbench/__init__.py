"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`); the mix's ``kind`` names the
driver (`drivers/<kind>.py`) that sets the cell up, runs its measured
window and checks its output against the plain reference the
configuration names (`reference/<name>.py`). Each metric is read from
the finished run by a reader of its own (`metrics/<name>.py`). So a new
configuration, mix or metric is a new file and a new entry, and no file
that is here changes. `run.py` is the command; `README.md` says more.
"""
