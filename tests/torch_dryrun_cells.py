"""Shared helpers of the dry-run tests: the smoke cells on a fake
2 x 4 ``("data", "model")`` mesh, with the argument bytes their specs
give (`repro_torch.launch.dryrun.spec_arg_bytes`)."""

import torch

from repro_torch.configs import base as pbase
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world

ARCHS = list(pbase.lm_arch_ids())
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
CELLS = [(a, k) for a in ARCHS for k in KINDS]


def smoke_mesh(device="cpu"):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device, torch.arange(8).reshape(2, 4),
                      mesh_dim_names=("data", "model"))


def run_smoke_cell(arch, kind, rules_name, device="cpu"):
    """The smoke cell's record on a fake 8-rank world and its argument
    bytes from the specs."""
    with fake_world(8):
        mesh = smoke_mesh(device)
        rec = dryrun.run_lm_cell(arch, KINDS[kind], False, rules_name,
                                 mesh=mesh, smoke=True)
        want = dryrun.spec_arg_bytes(pbase.get(arch).smoke, kind, mesh,
                                     dryrun._rules(rules_name), B=2, S=16)
    return rec, want


def check_record(rec, want_arg_bytes):
    assert rec["status"] == "ok"
    assert rec["chips"] == 8 and rec["mesh"] == "2x4"
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == want_arg_bytes
    assert mem["output_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["compile_s"] == 0.0
    roof = rec["roofline"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert sum(roof["collective_counts"].values()) > 0
    assert rec["params"] > 0 and 0 < rec["active_params"] <= rec["params"]
