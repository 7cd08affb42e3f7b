"""The port's dry-run on the CPU under TP: every (architecture, kind)
the reference does not skip gives an ``ok`` record at smoke size on a
fake 2 x 4 mesh (see ``test_torch_dryrun.py`` for what a record
holds)."""

import pytest
import torch

from torch_dryrun_cells import CELLS, check_record, run_smoke_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_smoke_cell_tp(arch, kind):
    rec, want = run_smoke_cell(arch, kind, "tp")
    check_record(rec, want)
    assert rec["rules"] == "tp"
