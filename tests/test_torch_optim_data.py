"""AdamW (``repro_torch.optim``) and the synthetic data pipeline
(``repro_torch.data``) against the reference's, on the CPU.

- ``schedule`` equals the reference's f32 values step for step;
- ``apply`` on a tree shaped like the reference's parameters (the
  smollm twin's, flattened in ``jax.tree`` order) against
  ``repro.optim.adamw.apply`` run op by op, over four steps. The global
  norm's f32 sums run in another order (the port's pairwise, the
  reference's more sequential), so it may differ by rel `NORM_REL`.
  With the clip inactive the scale is exactly 1 and every other value
  is within 1 ulp of its leaf's largest magnitude (`ulps`; the f32
  cases equal). With it active the scale passes the norm's difference
  on to the f32 moments (rel `NORM_REL`, ``nu`` twice; bf16 moments
  stay within 1 of their ulps), while Adam's ``m / sqrt(v)`` nearly
  cancels it: params and master copies stay within 4 ulps over the
  four steps (measured: 2 and 3), or, where a bf16 moment's rounding
  flips, within `BF16_MOMENT_FLIP` × lr. Under ``jax.jit`` XLA
  contracts ``b·m + (1-b)·g`` into fused multiply-adds, which neither
  the port nor the op-by-op reference does, so the unjitted reference
  is the one compared;
- ``SyntheticLM`` batches are equal to the reference's for several
  seeds, shards 0–3 of 4 and steps 0–5; ``DataState`` round-trips.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.data import pipeline as rdata
from repro.models import model as rmdl
from repro.optim import adamw as radamw
from repro_torch.data import DataConfig, DataState, SyntheticLM
from repro_torch.optim import adamw
from test_torch_lm_layers import draw_leaves

torch.set_num_threads(1)

STEPS = (0, 1, 9, 10, 55, 99, 100, 150)

#: the global norm's relative difference (module docstring)
NORM_REL = 1e-5
#: ulps of a leaf's largest magnitude with the clip inactive
ULPS = 1
#: with the clip active: the moments' relative difference, the params'
#: and master copies' ulps
ACTIVE_REL = {"mu": NORM_REL, "nu": 2 * NORM_REL}
ACTIVE_ULPS = 4
#: with bf16 moments and the clip active, a moment's bf16 rounding may
#: flip, moving its element's update by that spacing: the params stay
#: within this times the learning rate (absolute)
BF16_MOMENT_FLIP = 2.0 ** -6


def rel(want, got) -> float:
    a = np.asarray(want, np.float32)
    b = np.asarray(got.float(), np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def ulps(want, got) -> float:
    """``max|want - got|`` in units of the spacing of ``got``'s dtype
    (f32 or bf16) at ``max|want|``."""
    a = np.asarray(want, np.float32)
    b = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    assert a.shape == b.shape
    spacing = np.spacing(np.max(np.abs(a)))
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        spacing *= 2.0 ** 16            # 8 significand bits, not 24
    return float(np.max(np.abs(a - b)) / spacing)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 1), (0, 50)])
def test_schedule_equals_reference_f32(warmup, total):
    kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=total,
              min_lr_frac=0.1)
    rcfg, pcfg = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for s in STEPS:
        want = np.float32(radamw.schedule(rcfg, jnp.int32(s)))
        got = adamw.schedule(pcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert want == got.item(), (s, want, got.item())


def _leaves(tree, prefix=""):
    """``(path, leaf)`` in ``jax.tree.leaves`` order (dict keys
    sorted)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _pair(tree, jdt, tdt):
    """The same values as a reference tree in ``jdt`` and a flat port
    dict in ``tdt`` (bf16 rounded once, by JAX)."""
    rt = jax.tree.map(lambda x: jnp.asarray(x, jdt), tree)
    flat = {k: torch.as_tensor(np.array(v.astype(jnp.float32))).to(tdt)
            for k, v in _leaves(rt)}
    return rt, flat


CASES = {"f32": (False, "f32", "f32"),
         "bf16-state": (False, "f32", "bf16"),
         "bf16-params-master": (True, "bf16", "f32")}


@pytest.mark.parametrize("clip", ["inactive", "active"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_equals_reference(case, clip):
    master, pdt, sdt = CASES[case]
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    td = {"f32": torch.float32, "bf16": torch.bfloat16}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              clip_norm=1e9 if clip == "inactive" else 0.1,
              master_copy=master)
    rcfg = radamw.AdamWConfig(**kw, state_dtype=jd[sdt])
    pcfg = adamw.AdamWConfig(**kw, state_dtype=td[sdt])
    shapes, _ = rmdl.abstract_params(rbase.get("smollm_360m").smoke)
    rng = np.random.default_rng(7)
    rp, pp = _pair(draw_leaves(shapes, rng), jd[pdt], td[pdt])
    rs, ps = radamw.init(rcfg, rp), adamw.init(pcfg, pp)
    assert (ps.master is None) == (not master)
    active = clip == "active"
    for _ in range(4):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            shapes)
        rg, pg = _pair(grads, jd[pdt], td[pdt])
        rp, rs, rm = radamw.apply(rcfg, rs, rp, rg)
        pp, ps, pm = adamw.apply(pcfg, ps, pp, pg)
        assert int(rs.step) == int(ps.step)
        assert rel(rm["grad_norm"], pm["grad_norm"]) <= NORM_REL
        assert float(rm["lr"]) == pm["lr"].item()
        trees = [("params", rp, pp), ("mu", rs.mu, ps.mu),
                 ("nu", rs.nu, ps.nu)]
        if master:
            trees.append(("master", rs.master, ps.master))
        for what, rt, pt in trees:
            want_dtype = {"params": td[pdt],
                          "master": torch.float32}.get(what, td[sdt])
            for k, v in _leaves(rt):
                assert pt[k].dtype == want_dtype, (what, k)
                want = np.asarray(v.astype(jnp.float32))
                if active and what in ACTIVE_REL and \
                        want_dtype == torch.float32:
                    err = rel(want, pt[k])
                    assert err <= ACTIVE_REL[what], (what, k, err)
                elif active and sdt == "bf16" and what == "params":
                    err = float(np.max(np.abs(want - pt[k].numpy())))
                    assert err <= BF16_MOMENT_FLIP * kw["lr"], (k, err)
                else:
                    err = ulps(want, pt[k])
                    assert err <= (ACTIVE_ULPS if active else ULPS), \
                        (what, k, err)


def test_global_norm_and_init_match_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    rt, flat = _pair(tree, jnp.float32, torch.float32)
    assert ulps(radamw.global_norm(rt), adamw.global_norm(flat)) <= ULPS
    st = adamw.init(adamw.AdamWConfig(master_copy=True), flat)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for k, v in flat.items():
        assert torch.equal(st.master[k], v) and not st.mu[k].any()
        assert st.mu[k] is not st.nu[k]


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_batches_equal_reference(seed):
    kw = dict(vocab=97, seq_len=9, global_batch=8, seed=seed)
    for shard in range(4):
        ref = rdata.SyntheticLM(rdata.DataConfig(**kw), shard, 4)
        port = SyntheticLM(DataConfig(**kw), shard, 4)
        assert np.array_equal(ref.trans, port.trans)
        rs, ps = rdata.DataState(), DataState()
        for step in range(6):
            rb, rs = ref.batch(rs)
            pb, ps = port.batch(ps)
            assert rb.keys() == pb.keys() == {"tokens", "labels"}
            for k in rb:
                assert pb[k].dtype == rb[k].dtype == np.int32
                assert np.array_equal(rb[k], pb[k]), (seed, shard, step, k)
            assert ps.step == rs.step == step + 1


def test_iterator_and_full_batch_equal_reference():
    kw = dict(vocab=300, seq_len=16, global_batch=4, seed=5,
              markov_states=16)
    ref = iter(rdata.SyntheticLM(rdata.DataConfig(**kw)))
    port = iter(SyntheticLM(DataConfig(**kw)))
    for _ in range(3):
        rb, pb = next(ref), next(port)
        assert np.array_equal(rb["tokens"], pb["tokens"])
        assert np.array_equal(pb["labels"][:, :-1], pb["tokens"][:, 1:])


def test_data_state_round_trips_and_resumes():
    st = DataState(step=7)
    assert DataState.from_dict(st.to_dict()) == st
    assert st.to_dict() == rdata.DataState(step=7).to_dict()
    pipe = SyntheticLM(DataConfig(vocab=50, seq_len=4, global_batch=2))
    seq, s = [], DataState()
    for _ in range(5):
        b, s = pipe.batch(s)
        seq.append(b["tokens"])
    b3, _ = pipe.batch(DataState.from_dict({"step": 3}))
    assert np.array_equal(b3["tokens"], seq[3])
    with pytest.raises(AssertionError):
        SyntheticLM(DataConfig(vocab=50, seq_len=4, global_batch=3),
                    num_shards=2)


def test_config_fields_equal_reference():
    assert [f.name for f in dataclasses.fields(DataConfig)] == \
        [f.name for f in dataclasses.fields(rdata.DataConfig)]
    rf = dataclasses.asdict(radamw.AdamWConfig())
    pf = dataclasses.asdict(adamw.AdamWConfig())
    assert rf.keys() == pf.keys()
    for k in rf:
        if k != "state_dtype":
            assert rf[k] == pf[k], k
    assert pf["state_dtype"] == torch.float32
