"""One rank of a sharded LM step on the CPU: the port's smoke twin under
``TP_RULES`` on a 1 x 2 ``("data", "model")`` mesh of two processes
(``gloo``), against the same twin's one-process step.

    python tests/torch_sharded_step_driver.py <arch> <rank> <port> <out>

Both ranks build the twin from one seed in f32, lay its parameters out
by `repro_torch.parallel.sharding.resolve_params` (``distribute_tensor``)
and run `repro_torch.train.loss_and_grads` and one
`repro_torch.train.make_train_step` step on the same batch, sharded.
Rank 0 writes the loss, the gradients, the step's loss and the updated
parameters (whole tensors) to ``<out>`` (an ``.npz``).
"""

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist


def twin(arch):
    from repro_torch.configs import base
    return dataclasses.replace(base.get(arch).smoke, dtype=torch.float32)


def batch(cfg, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int64)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": torch.as_tensor(toks[:, :-1]),
            "labels": torch.as_tensor(labels)}


def model(cfg, seed=0):
    from repro_torch.models import model as mdl
    return mdl.randomize_params(mdl.init_params(cfg, seed, "cpu"), seed)


def main(arch, rank, port, out):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.dtensor import sharded_ops, shard_module_
    from repro_torch.parallel.logical import axis_rules
    from repro_torch.train import trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                          mesh_dim_names=("data", "model"))
        rules = shd.TP_RULES
        cfg = twin(arch)
        lm = model(cfg)
        pl = shd.resolve_params(lm.param_axes(), mesh, rules,
                                dict(lm.named_parameters()))
        shard_module_(lm, lambda k, p: distribute_tensor(p.detach(), mesh,
                                                         pl[k]))
        b = batch(cfg)
        b_sh = trainer.batch_shardings(mesh, rules, b)
        b = {k: distribute_tensor(v, mesh, b_sh[k]) for k, v in b.items()}
        with axis_rules(mesh, rules), sharded_ops():
            loss, _, grads = trainer.loss_and_grads(lm, b, remat=True)
            loss = loss.full_tensor()
            grads = {k: g.full_tensor() for k, g in grads.items()}
        ocfg = adamw.AdamWConfig()
        state = trainer.TrainState(
            params=lm, opt=adamw.init(ocfg, dict(lm.named_parameters())))
        step = trainer.make_train_step(cfg, ocfg, mesh, rules)
        state, metrics = step(state, b)
        step_loss = metrics["loss"].full_tensor()
        params = {k: p.full_tensor()
                  for k, p in state.params.named_parameters()}
        if rank == 0:
            arrays = {"loss": loss.numpy(), "step_loss": step_loss.numpy()}
            arrays.update({f"grad/{k}": g.numpy() for k, g in grads.items()})
            arrays.update({f"param/{k}": p.detach().numpy()
                           for k, p in params.items()})
            np.savez(out, **arrays)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
