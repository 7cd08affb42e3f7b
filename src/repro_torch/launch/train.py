"""Training launcher for the LM zoo.

    python -m repro_torch.launch.train --arch smollm_360m --smoke \
        --steps 300 --batch 8 --seq 128 --ckpt-dir /tmp/run1

Runs on ``--device`` (default: the card; it raises without CUDA;
``--device cpu`` runs on the CPU). Exercised end to end: remat'd
layer groups, AdamW with warmup, cosine schedule and clipping,
deterministic resumable data (`repro_torch.data.SyntheticLM`, the
reference's batches), checkpoints saved without blocking every
``--ckpt-every`` steps plus a final one, and crash resume
(``--resume``: the newest intact step, its data cursor included).
Checkpoints are the reference's format, so either package resumes the
other's. Weights start from a ``torch.Generator`` on the device seeded
with 0 (not ``jax.random``'s values).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import base as cfgbase
from repro_torch.data import DataConfig, DataState, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.interop import train_state
from repro_torch.optim import adamw
from repro_torch.train import trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = cfgbase.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                             total_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    pipe = SyntheticLM(dcfg)
    step_fn = trainer.make_train_step(cfg, ocfg)

    dstate = DataState()
    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume and mgr.latest_step() is not None:
        tmpl = trainer.state_tree(trainer.abstract_train_state(cfg, ocfg))
        tree, start, dd = mgr.restore(tmpl)
        state = train_state(cfg, ocfg, tree, dev)
        dstate = DataState.from_dict(dd)
        print(f"[resume] step {start}")
    else:
        state = trainer.init_train_state(cfg, ocfg, seed=0, device=dev)

    losses = []
    t0 = time.time()
    extras = {}
    if cfg.family == "vision":
        extras["image_embeds"] = torch.zeros(
            (dcfg.global_batch, cfg.n_image_tokens, cfg.d_model),
            device=dev)
    if cfg.family == "encdec":
        extras["audio_embeds"] = torch.zeros(
            (dcfg.global_batch, cfg.n_audio_tokens, cfg.d_model),
            device=dev)
    for step in range(start, args.steps):
        batch, dstate = pipe.batch(dstate)
        batch = dict({k: torch.as_tensor(v, device=dev)
                      for k, v in batch.items()}, **extras)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, trainer.state_tree(state),
                     data_state=dstate.to_dict(), blocking=False)
    if mgr:
        mgr.wait()
        if mgr.latest_step() != args.steps:
            mgr.save(args.steps, trainer.state_tree(state),
                     data_state=dstate.to_dict())
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return {"losses": losses, "state": state}


if __name__ == "__main__":
    main()
