"""AdamW with decoupled weight decay, global-norm clipping and
optional f32 master copies for bf16 params.

Plain functions on dicts of tensors keyed by parameter name (the
port's ``named_parameters()`` names), not a ``torch.optim.Optimizer``,
so that every arithmetic step follows the reference's
(``repro.optim.adamw``) in its order and dtypes:

- the learning rate is ``schedule(cfg, state.step)``, taken before the
  step counter moves; the bias corrections ``1 - b ** step`` after;
- the gradients are scaled by ``min(1, clip / (‖g‖ + 1e-9))``, with
  ``‖g‖`` the f32 global norm;
- the update is ``lr · ((m / bc1) / (sqrt(v / bc2) + eps) + wd · ref)``
  with weight decay on **every** leaf (norm scales and biases too),
  ``ref`` the f32 master copy when there is one;
- ``m`` and ``v`` are kept in ``state_dtype``.

Every scalar (the step, the rate, the clip scale) stays a 0-dim tensor
on the parameters' device, computed in f32 as the reference's are, so a
step never waits for the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_copy: bool = False    # keep f32 master when params are bf16
    state_dtype: Any = torch.float32   # bf16 halves m/v memory


class OptState(NamedTuple):
    step: Tensor                 # int32 []
    mu: Params
    nu: Params
    master: Optional[Params]


def init(cfg: AdamWConfig, params: Params) -> OptState:
    """Zero moments in ``state_dtype``, the step 0 (int32, on the
    parameters' device) and, with ``master_copy``, f32 copies."""
    zeros = {k: torch.zeros_like(p, dtype=cfg.state_dtype)
             for k, p in params.items()}
    master = None
    if cfg.master_copy:
        master = {k: p.detach().float().clone() for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros, nu={k: z.clone() for k, z in zeros.items()},
                    master=master)


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup → cosine decay to ``min_lr_frac``, in f32 tensors
    (the reference's ``jnp`` arithmetic; Python's f64 ``math`` would
    round differently)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    s = step.float()
    warm = torch.clamp((s + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: Params) -> Tensor:
    """``sqrt(Σ_leaves Σ x²)`` in f32, one partial sum a leaf, in the
    dict's order."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def apply(cfg: AdamWConfig, state: OptState, params: Params,
          grads: Params) -> Tuple[Params, OptState, Dict[str, Tensor]]:
    """One update. Returns ``(new params, new state, {"grad_norm",
    "lr"})``; nothing is written in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    new_p, new_m, new_v = {}, {}, {}
    new_master = {} if state.master is not None else None
    for k, p in params.items():
        g = grads[k].float() * scale
        m32 = b1 * state.mu[k].float() + (1 - b1) * g
        v32 = b2 * state.nu[k].float() + (1 - b2) * g * g
        ref = state.master[k] if state.master is not None else p.float()
        delta = lr * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
                      + cfg.weight_decay * ref)
        new_ref = ref - delta
        new_p[k] = new_ref.to(p.dtype)
        new_m[k] = m32.to(cfg.state_dtype)
        new_v[k] = v32.to(cfg.state_dtype)
        if new_master is not None:
            new_master[k] = new_ref
    return new_p, OptState(step=step, mu=new_m, nu=new_v,
                           master=new_master), \
        {"grad_norm": gnorm, "lr": lr}
