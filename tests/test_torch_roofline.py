"""The roofline machinery of the port against the reference's, on the
CPU.

- the constants are the H100 SXM5's published figures (dense bf16,
  HBM3, NVLink 4 one way) and no TPU figure is left;
- ``record_collective`` fed the events of ``test_roofline.py``'s HLO
  text (kind, result bytes, group size) gives the reference's
  ``parse_collectives`` of that text: counts, wire and payload bytes,
  bytes by kind;
- ``analytic_flops`` and ``model_flops_estimate`` equal the reference's
  for every architecture and shape;
- ``analyze`` names the largest term;
- on a fake 16 x 16 mesh, one sharded product (``[256, 4096] x [4096,
  16384]`` bf16, the contraction split over ``model``) and the
  all-reduce of its partial sums: ``StepCounter`` records rank 0's
  FLOPs (``2·16·256·16384``), the product's operand and result bytes,
  one all-reduce of ``[16, 16384]`` bf16 on a group of 16 and the peak
  of its live bytes, all by hand.
"""

import pytest
import torch

from repro.configs import base as rbase
from repro.roofline import analysis as rra
from repro_torch.configs import base as pbase
from repro_torch.roofline import analysis as ra

from test_roofline import HLO

ARCHS = list(rbase.lm_arch_ids())

#: the events of ``HLO``: (kind, result bytes, group size)
HLO_EVENTS = [
    ("all-gather", 8 * 2048 * 2, 16),
    ("all-reduce", 1024 * 4, 512),
    ("reduce-scatter", 64 * 4, 4),
    ("collective-permute", 32 * 32 * 2, 512),
    ("all-gather", (4 * 4 + 4 * 64) * 2, 16),
]


def test_constants_are_the_h100s():
    assert ra.PEAK_FLOPS == 989.4e12
    assert ra.HBM_BW == 3.35e12
    assert ra.LINK_BW == 450e9
    for name in ("ICI_BW",):
        assert not hasattr(ra, name)


def test_record_collective_equals_reference_parse():
    want = rra.parse_collectives(HLO, 512)
    st = ra.CollectiveStats()
    for kind, nbytes, n in HLO_EVENTS:
        ra.record_collective(st, kind, nbytes, n)
    assert st.counts == want.counts
    assert st.wire_bytes == want.wire_bytes
    assert st.payload_bytes == want.payload_bytes
    assert st.by_kind_bytes == want.by_kind_bytes


def test_record_collective_skips_empty_and_refuses_unknown():
    st = ra.CollectiveStats()
    ra.record_collective(st, "all-reduce", 0, 8)
    assert st.counts == {} and st.wire_bytes == 0.0
    with pytest.raises(ValueError):
        ra.record_collective(st, "broadcast", 4, 2)


@pytest.mark.parametrize("shape", [s.name for s in rbase.SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_flop_models_equal_reference(arch, shape):
    rcfg, pcfg = rbase.get(arch).config, pbase.get(arch).config
    rs, ps = rbase.SHAPE_BY_NAME[shape], pbase.SHAPE_BY_NAME[shape]
    assert ra.analytic_flops(pcfg, ps) == rra.analytic_flops(rcfg, rs)
    assert ra.model_flops_estimate(pcfg, ps) == \
        rra.model_flops_estimate(rcfg, rs)


def test_analyze_names_the_largest_term():
    st = ra.CollectiveStats()
    ra.record_collective(st, "all-reduce", 450e9, 2)    # 1 s of wire
    roof = ra.analyze(989.4e12 * 2, 3.35e12 * 0.5, st, chips=4,
                      model_flops_total=4 * 989.4e12)
    assert roof.bottleneck == "compute"
    assert roof.compute_s == 2.0 and roof.memory_s == 0.5
    assert roof.collective_s == 1.0
    assert roof.useful_ratio == 0.5
    d = roof.to_dict()
    assert d["collective_counts"] == {"all-reduce": 1}
    assert "collectives" not in d


def test_step_counter_on_a_fake_16x16_mesh():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.parallel.dtensor import fake_dtensor
    with fake_world():
        mesh = make_production_mesh(device="cpu")
        fm = FakeTensorMode()
        x = fake_dtensor((256, 4096), torch.bfloat16, mesh,
                         [Shard(0), Shard(1)], fm)
        w = fake_dtensor((4096, 16384), torch.bfloat16, mesh,
                         [Replicate(), Shard(0)], fm)
        c = ra.StepCounter()
        c.exclude([x._local_tensor, w._local_tensor])
        with fm, c:
            y = torch.mm(x, w)
            assert list(y.placements) == [Shard(0), Partial()]
            z = y.redistribute(mesh, [Shard(0), Replicate()])
        assert tuple(z._local_tensor.shape) == (16, 16384)
    out = 16 * 16384 * 2
    assert c.flops == 2 * 16 * 256 * 16384
    assert c.bytes == 16 * 256 * 2 + 256 * 16384 * 2 + out
    assert c.coll.counts == {"all-reduce": 1}
    assert c.coll.payload_bytes == out
    assert c.coll.wire_bytes == 2 * out * 15 / 16
    assert c.peak_bytes == 2 * out          # the product and the reduce
