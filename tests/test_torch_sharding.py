"""The LM zoo's logical axes and sharding rules in the port against the
reference's, on the CPU, and a sharded step against an unsharded one.

- ``LM.param_axes()`` of every architecture (full size) equals the
  reference's ``abstract_params(cfg)[1]`` leaf for leaf (the port's
  per-layer parameter without the reference's leading ``"layers"``);
- the four rule sets and ``head_dim_fallback`` equal the reference's;
- for every architecture, the rule sets (and ``head_dim_fallback`` of
  FSDP) and the 16 x 16, 2 x 16 x 16 and 32 x 8 meshes, the port's
  ``spec_for`` of each parameter equals the reference's of the matching
  leaf without its ``"layers"`` entry, and so do the decode state's
  specs (``serve_state_specs`` against ``serve_state_shardings``) and
  the batch's. The reference's ``spec_for`` reads only
  ``dict(mesh.shape)``, so a stand-in mesh serves it; its
  ``NamedSharding`` is replaced by the bare spec;
- ``placements`` lays a spec out on a ``DeviceMesh`` (two axes on one
  dimension shard it on both mesh dimensions);
- ``constrain`` is the identity outside ``axis_rules`` and on a plain
  tensor;
- a sharded step computes what an unsharded one does: two CPU
  processes (``gloo``) run the smoke twins of smollm-360m and
  qwen3-moe under ``TP_RULES`` on a 1 x 2 mesh
  (``torch_sharded_step_driver.py``); their loss, gradients and one
  train step's loss and parameters equal the one-process step's within
  1e-5 (f32; relative norm a leaf).
"""

import functools
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch import specs as rspecs
from repro.models import model as rmdl
from repro.parallel import logical as rlogical
from repro.parallel import sharding as rshd
from repro.train import trainer as rtrainer
from repro_torch import interop
from repro_torch.configs import base as pbase
from repro_torch.launch import specs as pspecs
from repro_torch.models import model as mdl
from repro_torch.parallel import logical, sharding as shd
from repro_torch.train import trainer

import torch_sharded_step_driver as driver

torch.set_num_threads(1)

ARCHS = list(rbase.lm_arch_ids())
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "32x8": {"data": 32, "model": 8}}
RULES = {"tp": "TP_RULES", "fsdp": "FSDP_RULES",
         "fsdp_opt": "FSDP_OPT_RULES", "sp": "SP_RULES"}


def _mesh(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _rules(pkg, name):
    if name == "head_dim":
        return pkg.head_dim_fallback(pkg.FSDP_RULES)
    return getattr(pkg, RULES[name])


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@functools.lru_cache(maxsize=None)
def _ref(arch):
    shapes, axes = rmdl.abstract_params(rbase.get(arch).config)
    return dict(_flat(shapes)), dict(_flat(axes))


@functools.lru_cache(maxsize=None)
def _port(arch):
    model = mdl.abstract_params(pbase.get(arch).config)
    return ({k: tuple(p.shape) for k, p in model.named_parameters()},
            model.param_axes())


def _pairs(arch):
    """``(port name, port shape, port axes, ref shape, ref axes)``."""
    ref_shapes, ref_axes = _ref(arch)
    shapes, axes = _port(arch)
    for name, ax in axes.items():
        path, g = interop._ref_path(name)
        yield (name, shapes[name], ax, tuple(ref_shapes[path].shape),
               ref_axes[path], g)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_reference(arch):
    ref_shapes, ref_axes = _ref(arch)
    _, axes = _port(arch)
    seen = set()
    for name, shape, ax, rshape, rax, g in _pairs(arch):
        seen.add(interop._ref_path(name)[0])
        if g is None:
            assert ax == rax, name
        else:
            assert rax[0] == "layers" and ax == rax[1:], name
            assert shape == rshape[1:], name
    assert seen == set(ref_axes)


def test_rule_sets_equal_reference():
    for name in RULES:
        assert _rules(shd, name) == _rules(rshd, name), name
    assert _rules(shd, "head_dim") == _rules(rshd, "head_dim")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    m = _mesh(mesh)
    for rules in list(RULES) + ["head_dim"]:
        prules, rrules = _rules(shd, rules), _rules(rshd, rules)
        for name, shape, ax, rshape, rax, g in _pairs(arch):
            want = tuple(rlogical.spec_for(rax, rrules, m, rshape))
            if g is not None:
                assert want[0] is None
                want = want[1:]
            got = logical.spec_for(ax, prules, m, shape)
            assert got == want, (rules, name)


@pytest.fixture
def bare_named_sharding(monkeypatch):
    monkeypatch.setattr(rtrainer, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_state_and_batch_specs_equal_reference(arch, mesh,
                                                     bare_named_sharding):
    m = _mesh(mesh)
    pcfg, rcfg = pbase.get(arch).config, rbase.get(arch).config
    for shape in pbase.SHAPES:
        if shape.kind == "train":
            continue
        B, S = shape.global_batch, shape.seq_len
        for rules in ("fsdp", "tp"):
            prules, rrules = _rules(shd, rules), _rules(rshd, rules)
            want, rstate = rtrainer.serve_state_shardings(rcfg, m, rrules,
                                                          B, S)
            got, state = trainer.serve_state_specs(pcfg, m, prules, B, S)
            assert set(got) == set(want)
            assert got["pos"] is None and tuple(want["pos"]) == ()
            for k in got:
                if k == "pos":
                    continue
                assert set(got[k]) == set(want[k]), k
                for leaf, spec in got[k].items():
                    assert tuple(state[k][leaf].shape) == \
                        tuple(rstate[k][leaf].shape), (k, leaf)
                    assert spec == tuple(want[k][leaf]), (rules, k, leaf)
    for shape in pbase.SHAPES:
        B, S = shape.global_batch, shape.seq_len
        rb = rspecs._batch_specs(rcfg, B, S, shape.kind)
        pb = pspecs._batch_specs(pcfg, B, S, shape.kind)
        assert set(rb) == set(pb)
        for rules in RULES:
            prules, rrules = _rules(shd, rules), _rules(rshd, rules)
            want = rtrainer.batch_shardings(m, rrules, rb)
            for k, x in pb.items():
                assert tuple(x.shape) == tuple(rb[k].shape)
                got = shd.batch_spec(m, prules, x.dim(), x.shape)
                assert got == tuple(want[k]), (rules, k)


def test_placements_on_a_device_mesh():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    with fake_world():
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        spec = logical.spec_for(["batch", None, "q_heads", "head_dim"],
                                shd.FSDP_RULES, mesh, (64, 3, 32, 128))
        assert spec == (("pod", "data"), None, "model", None)
        assert logical.placements(spec, mesh) == [Shard(0), Shard(0),
                                                  Shard(2)]
        assert logical.local_shape((64, 3, 32, 128), spec, mesh) == \
            (2, 3, 2, 128)
        assert shd.replicated(mesh) == [Replicate()] * 3


def test_constrain_is_identity_without_rules_or_dtensor():
    x = torch.ones(4, 3)
    assert logical.constrain(x, "batch", "embed") is x
    with logical.axis_rules(_mesh("16x16"), shd.FSDP_RULES):
        assert logical.current_rules()[1] == shd.FSDP_RULES
        assert logical.constrain(x, "batch", "embed") is x
    assert logical.current_rules() is None


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen3_moe_235b_a22b"])
def test_two_process_sharded_step_equals_one_process(arch, tmp_path):
    out = tmp_path / "rank0.npz"
    port = _free_port()
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(src), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, driver.__file__, arch, str(r), str(port),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    z = np.load(out)

    cfg = driver.twin(arch)
    lm = driver.model(cfg)
    b = driver.batch(cfg)
    loss, _, grads = trainer.loss_and_grads(lm, b, remat=True)
    assert _rel(z["loss"], loss.numpy()) <= 1e-5
    for k, g in grads.items():
        assert _rel(z[f"grad/{k}"], g.numpy()) <= 1e-5, k
    from repro_torch.optim import adamw
    ocfg = adamw.AdamWConfig()
    state = trainer.TrainState(
        params=lm, opt=adamw.init(ocfg, dict(lm.named_parameters())))
    state, metrics = trainer.make_train_step(cfg, ocfg)(state, b)
    assert _rel(z["step_loss"], metrics["loss"].numpy()) <= 1e-5
    for k, p in state.params.named_parameters():
        assert _rel(z[f"param/{k}"], p.detach().numpy()) <= 1e-5, k


def test_mesh_builders():
    from repro_torch.launch import mesh as lm
    with pytest.raises(RuntimeError, match="world"):
        lm.make_production_mesh(device="cpu")
    with lm.fake_world(8):
        with pytest.raises(RuntimeError, match="already"):
            with lm.fake_world(8):
                pass
        smoke = lm.make_smoke_mesh("cpu")
        assert smoke.mesh_dim_names == ("data", "model")
        assert tuple(smoke.shape) == (1, 8)
        with pytest.raises(RuntimeError, match="256"):
            lm.make_production_mesh(device="cpu")
    with lm.fake_world():
        pod = lm.make_production_mesh(multi_pod=True, device="cpu")
        assert pod.mesh_dim_names == ("pod", "data", "model")
        assert tuple(pod.shape) == (2, 16, 16)
        dm = lm.make_production_mesh(dm_shape=(32, 8), device="cpu")
        assert logical.mesh_shape(dm) == {"data": 32, "model": 8}
        with pytest.raises(ValueError):
            lm.make_production_mesh(dm_shape=(16, 8), device="cpu")
    flat = lm.make_flat_mesh(3, "cpu")
    assert flat.q == 3 and flat.axis == "node"
