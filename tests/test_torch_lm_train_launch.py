"""The LM training launcher, exact resume and training checkpoints
across the packages, on the CPU.

- ``python -m repro_torch.launch.train --smoke --device cpu``: the loss
  falls, a checkpoint lands every ``--ckpt-every`` steps and at the
  end, and ``--resume`` runs only the steps left, equal to the run
  that was not interrupted;
- interrupted training (3 steps, a checkpoint, a fresh state restored
  from it, 3 more) equals 6 uninterrupted steps, bit for bit;
- training checkpoints cross the packages both ways: a step saved by
  either manager holds the reference's keys in its order, and a state
  saved by one package, restored by the other, continues to the
  saver's uninterrupted losses (f32, rel 1e-5, the reference's own
  bound in ``tests/test_substrate.py``); the reference's launcher
  writes the manifest keys the port's writes, and the port's launcher
  resumes from the reference's checkpoint;
- ``examples.train_lm.main(device="cpu")`` trains 200 steps with its
  checkpoints under the temporary directory.
"""

import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.data import DataConfig as RefDataConfig
from repro.data import DataState as RefDataState
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch import train as rtrain
from repro.launch.mesh import make_smoke_mesh
from repro.parallel.sharding import TP_RULES
from repro.train import trainer as rtrainer
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten
from repro_torch.data import DataConfig, DataState, SyntheticLM
from repro_torch.examples import train_lm
from repro_torch.launch import train
from repro_torch.train import trainer
from test_torch_lm_train import opt_configs, ref_state
from test_torch_lm_archs import twin_configs

torch.set_num_threads(1)

ARGS = ["--arch", "smollm_360m", "--smoke", "--steps", "8", "--batch", "4",
        "--seq", "16", "--log-every", "1", "--device", "cpu"]
#: the reference's resume bound (``tests/test_substrate.py``)
RTOL = 1e-5


def manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "run")
    out = train.main(ARGS + ["--ckpt-dir", d, "--ckpt-every", "3"])
    losses = out["losses"]
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    assert CheckpointManager(d).all_steps() == [3, 6, 8]
    assert manifest(d, 8)["data_state"] == {"step": 8}
    printed = capsys.readouterr().out
    assert "step     0 loss" in printed and "final loss" in printed
    assert int(out["state"].opt.step) == 8
    shutil.rmtree(os.path.join(d, f"step_{8:010d}"))
    again = train.main(ARGS + ["--ckpt-dir", d, "--ckpt-every", "3",
                               "--resume"])
    assert "[resume] step 6" in capsys.readouterr().out
    assert again["losses"] == losses[6:]
    assert CheckpointManager(d).latest_step() == 8


def test_launcher_refuses_without_a_device_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])


def _port_run(cfg, ocfg, state, pipe, dstate, n):
    step = trainer.make_train_step(cfg, ocfg)
    losses = []
    for _ in range(n):
        batch, dstate = pipe.batch(dstate)
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return state, dstate, losses


def _ref_run(cfg, ocfg, state, pipe, dstate, n):
    step = jax.jit(rtrainer.make_train_step(cfg, ocfg, make_smoke_mesh(),
                                            TP_RULES))
    losses = []
    for _ in range(n):
        batch, dstate = pipe.batch(dstate)
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        state = jax.tree.map(np.asarray, state)
        losses.append(float(m["loss"]))
    return state, dstate, losses


def _setup():
    rcfg, pcfg = twin_configs("smollm_360m", "f32")
    rocfg, pocfg = opt_configs()
    kw = dict(vocab=rcfg.vocab, seq_len=8, global_batch=4)
    return (rcfg, pcfg, rocfg, pocfg, RefSyntheticLM(RefDataConfig(**kw)),
            SyntheticLM(DataConfig(**kw)), ref_state(rcfg, rocfg, seed=0))


def test_interrupted_training_equals_uninterrupted(tmp_path):
    _, cfg, _, ocfg, _, pipe, st0 = _setup()
    fresh = lambda: interop.train_state(cfg, ocfg, st0, "cpu")  # noqa: E731
    _, _, want = _port_run(cfg, ocfg, fresh(), pipe, DataState(), 6)
    st, ds, first = _port_run(cfg, ocfg, fresh(), pipe, DataState(), 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, trainer.state_tree(st), data_state=ds.to_dict())
    del st
    tmpl = trainer.state_tree(trainer.abstract_train_state(cfg, ocfg))
    tree, step, dd = mgr.restore(tmpl)
    assert step == 3 and dd == {"step": 3}
    st = interop.train_state(cfg, ocfg, tree, "cpu")
    assert int(st.opt.step) == 3
    _, _, rest = _port_run(cfg, ocfg, st, pipe, DataState.from_dict(dd), 3)
    assert first + rest == want


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    rcfg, pcfg, rocfg, pocfg, rpipe, pipe, st0 = _setup()
    _, _, want = _ref_run(rcfg, rocfg, st0, rpipe, RefDataState(), 6)
    st, ds, first = _ref_run(rcfg, rocfg, st0, rpipe, RefDataState(), 3)
    RefManager(str(tmp_path)).save(3, st, data_state=ds.to_dict())
    tmpl = trainer.state_tree(trainer.abstract_train_state(pcfg, pocfg))
    assert manifest(str(tmp_path), 3)["keys"] == [k for k, _ in
                                                  flatten(tmpl)]
    tree, step, dd = CheckpointManager(str(tmp_path)).restore(tmpl)
    pst = interop.train_state(pcfg, pocfg, tree, "cpu")
    _, _, rest = _port_run(pcfg, pocfg, pst, pipe, DataState.from_dict(dd), 3)
    np.testing.assert_allclose(first + rest, want, rtol=RTOL)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    rcfg, pcfg, rocfg, pocfg, rpipe, pipe, st0 = _setup()
    fresh = lambda: interop.train_state(pcfg, pocfg, st0, "cpu")  # noqa: E731
    _, _, want = _port_run(pcfg, pocfg, fresh(), pipe, DataState(), 6)
    st, ds, first = _port_run(pcfg, pocfg, fresh(), pipe, DataState(), 3)
    CheckpointManager(str(tmp_path)).save(3, trainer.state_tree(st),
                                          data_state=ds.to_dict())
    tmpl = jax.eval_shape(lambda: rtrainer.init_train_state(
        rcfg, rocfg, jax.random.key(0)))
    rst, step, dd = RefManager(str(tmp_path)).restore(tmpl)
    assert step == 3
    rst = jax.tree.map(np.asarray, rst)
    _, _, rest = _ref_run(rcfg, rocfg, rst, rpipe,
                          RefDataState.from_dict(dd), 3)
    np.testing.assert_allclose(first + rest, want, rtol=RTOL)


def test_launchers_write_the_same_keys_and_resume_each_other(tmp_path):
    """Both launchers on the (bf16) smoke twin: the same manifest keys
    and data cursor; the port's launcher resumes the reference's step
    and ends near its losses (bf16, the reference's bound 1e-2)."""
    rd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    common = ["--arch", "smollm_360m", "--smoke", "--steps", "6",
              "--batch", "4", "--seq", "16", "--ckpt-every", "3"]
    ref = rtrain.main(common + ["--ckpt-dir", rd])
    train.main(common + ["--ckpt-dir", pd, "--device", "cpu"])
    for s in (3, 6):
        assert manifest(rd, s)["keys"] == manifest(pd, s)["keys"]
        assert manifest(rd, s)["data_state"] == manifest(pd, s)[
            "data_state"]
    shutil.rmtree(os.path.join(rd, f"step_{6:010d}"))
    out = train.main(common + ["--ckpt-dir", rd, "--resume",
                               "--device", "cpu"])
    assert len(out["losses"]) == 3
    np.testing.assert_allclose(out["losses"], ref["losses"][3:], rtol=1e-2)


def test_train_lm_example_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = train_lm.main(device="cpu")
    assert len(out["losses"]) == 200
    assert out["losses"][-1] < out["losses"][0]
    assert CheckpointManager(str(tmp_path / "repro_torch_train_example")
                             ).all_steps() == [100, 200]
