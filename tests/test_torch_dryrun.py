"""The port's dry-run on the CPU.

- every (architecture, kind) the reference does not skip gives an
  ``ok`` record at smoke size under FSDP on a fake 2 x 4 mesh (TP in
  ``test_torch_dryrun_tp.py``): the step traced on fake DTensors, rank
  0's argument bytes equal to the count from the specs (parameters by
  ``resolve_params``' layout, AdamW's moments, the batch, the decode
  state), outputs, temporaries, FLOPs, bytes and a bottleneck, and at
  least one collective;
- the CHL cells: PLaNT is collective-free and DGLL exchanges, and one
  real superstep at the SMOKE size on 8 logical nodes holds the closed
  forms (one node's operand bytes, ``collectives.BYTES``);
- the closed forms of the collectives at q nodes are what
  ``collectives`` counts;
- the CLI writes JSONL and refuses to run without a card unless given
  ``--device cpu``; the fake world is closed after it.
"""

import json

import pytest
import torch

from repro_torch.launch import dryrun

from torch_dryrun_cells import CELLS, check_record, run_smoke_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_smoke_cell_fsdp(arch, kind):
    rec, want = run_smoke_cell(arch, kind, "fsdp")
    check_record(rec, want)
    assert rec["rules"] == "fsdp"


@pytest.mark.parametrize("shape", dryrun.CHL_SHAPES)
@pytest.mark.parametrize("arch", ["chl_road", "chl_scalefree"])
def test_chl_cell(arch, shape):
    rec = dryrun.run_chl_cell(arch, shape, False, device="cpu", check_q=8)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["mesh"] == "flat256"
    calls = rec["check"]["collective_calls"]
    if shape == "plant":
        assert rec["collective_free"] is True
        assert sum(calls.values()) == 0
        assert rec["roofline"]["collective_counts"] == {}
    else:
        assert rec["collective_free"] is False
        assert calls["all_gather"] == 3 and calls["pmax"] == 1
        assert rec["roofline"]["collective_counts"] == {"all-gather": 3,
                                                        "all-reduce": 1}
    from repro_torch.configs import chl_road, chl_scalefree
    cfg = {"chl_road": chl_road, "chl_scalefree": chl_scalefree}[arch].CONFIG
    assert rec["memory"]["argument_size_in_bytes"] == dryrun.chl_arg_bytes(
        cfg.n, cfg.max_deg, cfg.trees_per_node, cfg.cap)


def test_chl_collective_closed_forms():
    q, n, T = 4, 10, 3
    dense = dryrun.chl_collectives(q, n, T, plant=False)
    assert dryrun.collectives_bytes(q, dense) == {
        "all_gather": 3 * 4 * (T * 4 + T * n + T * n * 4),
        "pmax": 3 * 4 * q * T * n * 4}
    compact = dryrun.chl_collectives(q, n, T, plant=False, compact=2)
    assert dryrun.collectives_bytes(q, compact)["pmax"] == \
        3 * 4 * q * T * 2 * 4
    assert dryrun.chl_collectives(q, n, T, plant=True) == {}
    st = dryrun.chl_collective_stats(q, dense)
    assert st.counts == {"all-gather": 3, "all-reduce": 1}
    assert st.payload_bytes == q * (T * 4 + T * n + T * n * 4) \
        + q * T * n * 4


def test_cli_writes_jsonl_and_needs_a_device(tmp_path, monkeypatch):
    import torch.distributed as dist
    out = tmp_path / "dry.jsonl"
    argv = ["--arch", "chl_scalefree", "--shape", "plant", "--mesh",
            "single", "--out", str(out)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(argv)
    assert not out.exists()
    recs = dryrun.main(argv + ["--device", "cpu"])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == recs and len(lines) == 1
    assert lines[0]["status"] == "ok" and lines[0]["collective_free"]
    assert not dist.is_initialized()
