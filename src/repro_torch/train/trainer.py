"""Train, eval and serve step factories of the LM zoo.

`make_train_step` / `make_eval_step` / `make_serve_fns` close over the
model (and optimizer) configuration and return plain functions. The
reference's factories also take a device mesh and logical sharding
rules; one card has no mesh, so these take neither.

A `TrainState` holds the `repro_torch.models.LM` itself as ``params``
and AdamW's `OptState` keyed by the model's parameter names. A train
step updates the model's parameters in place and returns the state
with the new optimizer state: never reuse a state after passing it to
a step. `state_tree` gives the state in the reference's layout (the
layout of its checkpoints); `repro_torch.interop.train_state` is the
way back.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import model as mdl
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any                  # the LM (an nn.Module)
    opt: adamw.OptState


def init_train_state(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                     seed: int = 0, device: DeviceLike = None
                     ) -> TrainState:
    """A fresh `LM` (`models.init_params`: drawn from a generator on
    ``device`` seeded with ``seed``; default device the card) and its
    AdamW state."""
    model = mdl.init_params(cfg, seed=seed, device=device)
    return TrainState(params=model,
                      opt=adamw.init(ocfg, dict(model.named_parameters())))


def abstract_train_state(cfg: ModelConfig,
                         ocfg: adamw.AdamWConfig) -> TrainState:
    """The full train state on the ``meta`` device: shapes and dtypes,
    nothing allocated."""
    model = mdl.abstract_params(cfg)
    named = dict(model.named_parameters())

    def like(dtype):
        return {k: torch.empty(p.shape, dtype=dtype, device="meta")
                for k, p in named.items()}

    return TrainState(params=model, opt=adamw.OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=like(ocfg.state_dtype), nu=like(ocfg.state_dtype),
        master=like(torch.float32) if ocfg.master_copy else None))


def state_tree(state: TrainState) -> TrainState:
    """``state`` in the reference's layout: a `TrainState` whose
    ``params`` and ``opt.mu``/``nu``/``master`` are nested dicts with
    each stack leaf stacked ``[G, ...]`` (new tensors on the state's
    device). This is what a checkpoint holds: its keys are the
    reference's (``.params['dec']['blk0']['attn']['wq']``,
    ``.opt.step``, ...)."""
    from repro_torch.interop import lm_tree
    opt = state.opt
    return TrainState(
        params=lm_tree(dict(state.params.named_parameters())),
        opt=adamw.OptState(
            step=opt.step, mu=lm_tree(opt.mu), nu=lm_tree(opt.nu),
            master=None if opt.master is None else lm_tree(opt.master)))


def loss_and_grads(model, batch: Dict[str, Tensor], remat: bool = True):
    """(loss, metrics, {name: grad}); a parameter the loss does not
    reach gets a zero gradient, as under ``jax.grad``."""
    names, params = zip(*model.named_parameters())
    loss, metrics = mdl.loss_fn(model, batch, remat=remat)
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


def make_train_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig, *,
                    remat: bool = True, accum_steps: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    loss's metrics plus ``loss``, ``grad_norm`` and ``lr``.

    ``accum_steps > 1``: gradient accumulation over microbatches (the
    batch's leading axis split in ``accum_steps``); the optimizer sees
    the mean of their f32 gradients. Its metrics are the reference's
    accumulation branch's: ``nll`` the mean loss, ``aux`` 0 and
    ``tokens`` the number of tokens in the batch (not the mask's sum).
    """

    def train_step(state: TrainState, batch: Dict[str, Tensor]):
        model = state.params
        if model.cfg != cfg:
            raise ValueError(f"train step made for {cfg.name} was given "
                             f"a model of {model.cfg.name}")
        if accum_steps == 1:
            loss, metrics, grads = loss_and_grads(model, batch, remat)
        else:
            B = batch["tokens"].shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum_steps} microbatches")
            mb = B // accum_steps
            dev = model.device
            g_acc = {k: torch.zeros(p.shape, device=dev)
                     for k, p in model.named_parameters()}
            loss = torch.zeros((), device=dev)
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _, g = loss_and_grads(model, micro, remat)
                g_acc = {k: g_acc[k] + g[k] for k in g_acc}
                loss = loss + l
            grads = {k: g / accum_steps for k, g in g_acc.items()}
            loss = loss / accum_steps
            metrics = {"nll": loss, "aux": torch.zeros((), device=dev),
                       "tokens": torch.tensor(
                           float(batch["tokens"].numel()), device=dev)}
        params = {k: p.detach() for k, p in model.named_parameters()}
        new_params, opt, om = adamw.apply(ocfg, state.opt, params, grads)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return TrainState(params=model, opt=opt), dict(metrics, loss=loss,
                                                       **om)

    return train_step


def make_eval_step(cfg: ModelConfig):
    """Returns ``eval_step(params, batch) -> metrics``: the loss's
    metrics plus ``loss``, without remat or autograd."""

    def eval_step(params, batch: Dict[str, Tensor]):
        if params.cfg != cfg:
            raise ValueError(f"eval step made for {cfg.name} was given a "
                             f"model of {params.cfg.name}")
        with torch.no_grad():
            loss, metrics = mdl.loss_fn(params, batch, remat=False)
        return dict(metrics, loss=loss)

    return eval_step


def make_serve_fns(cfg: ModelConfig):
    """Returns ``(prefill_fn, decode_fn)``:

    - ``prefill_fn(params, batch, state) -> (logits, state, memory)``;
    - ``decode_fn(params, token, state, cross_memory=None) -> (logits,
      state)``;

    where ``params`` is the `repro_torch.models.LM` built for ``cfg``.
    Both run under ``torch.inference_mode()`` and write the state's
    caches in place."""

    def _check(params):
        if params.cfg != cfg:
            raise ValueError(f"serve fns made for {cfg.name} were given "
                             f"a model of {params.cfg.name}")

    def prefill_fn(params, batch, state):
        _check(params)
        return params.prefill(batch, state)

    def decode_fn(params, token, state, cross_memory=None):
        _check(params)
        return params.decode_step(token, state, cross_memory)

    return prefill_fn, decode_fn
