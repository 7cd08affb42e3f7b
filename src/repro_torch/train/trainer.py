"""Train, eval and serve step factories of the LM zoo.

`make_train_step` / `make_eval_step` / `make_serve_fns` close over the
model (and optimizer) configuration and return plain functions. Given a
``DeviceMesh`` and logical rules (`repro_torch.parallel.sharding`), a
step runs under them (`repro_torch.parallel.logical.axis_rules` and
`repro_torch.parallel.dtensor.sharded_ops`) on a model and state whose
tensors are DTensors laid out by `state_shardings` /
`serve_state_shardings` / `batch_shardings`: the activations are pinned
at the model's `constrain` sites and the collectives are DTensor's.
Without a mesh (one card) a step is the single-device one.

A `TrainState` holds the `repro_torch.models.LM` itself as ``params``
and AdamW's `OptState` keyed by the model's parameter names. A train
step updates the model's parameters in place and returns the state
with the new optimizer state: never reuse a state after passing it to
a step. `state_tree` gives the state in the reference's layout (the
layout of its checkpoints); `repro_torch.interop.train_state` is the
way back.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import model as mdl
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.dtensor import sharded_ops
from repro_torch.parallel.logical import (Spec, axis_rules, mesh_shape,
                                          placements, spec_for)

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


def state_shardings(cfg: ModelConfig, ocfg: adamw.AdamWConfig, mesh,
                    rules: Dict[str, Any]) -> TrainState:
    """DTensor placements matching `abstract_train_state`: a
    `TrainState` whose ``params`` and ``opt.mu``/``nu``/``master`` map
    each parameter name to its placements, ``opt.step`` replicated."""
    model = mdl.abstract_params(cfg)
    p_sh = shd.resolve_params(model.param_axes(), mesh, rules,
                              dict(model.named_parameters()))
    return TrainState(params=p_sh, opt=adamw.OptState(
        step=shd.replicated(mesh), mu=p_sh, nu=p_sh,
        master=p_sh if ocfg.master_copy else None))


def batch_shardings(mesh, rules: Dict[str, Any],
                    batch: Dict[str, Any]) -> Dict[str, Any]:
    """Placements of each batch tensor: the leading dimension
    ``"batch"``."""
    return {k: shd.batch_sharding(mesh, rules, len(x.shape), x.shape)
            for k, x in batch.items()}


def serve_state_specs(cfg: ModelConfig, mesh, rules: Dict[str, Any],
                      B: int, S_max: int) -> Tuple[Dict[str, Any],
                                                   Dict[str, Any]]:
    """``(specs, state)``: the decode state on the ``meta`` device and a
    spec a tensor (``None`` for the int ``"pos"``). A stacked ``[G, B,
    ...]`` state has the batch on dimension 1 and one model-sharded
    dimension: the last (scanning from the end) that the TP axis
    divides, stopping at one at least 8x its size (the head_dim of a KV
    cache, the d_inner of an SSM state)."""
    state = mdl.init_serve_state(cfg, B, S_max, device="meta")
    model_size = mesh_shape(mesh).get("model", 1)

    def one(x) -> Spec:
        if x.dim() == 0:
            return ()
        names: list = [None] * x.dim()
        if x.dim() >= 2:
            names[1] = "batch"
        pick = None
        for i in range(x.dim() - 1, 1, -1):
            if x.shape[i] % model_size == 0:
                pick = i
                if x.shape[i] >= 8 * model_size:
                    break
        if pick is not None:
            names[pick] = "act_heads"
        return spec_for(names, rules, mesh, x.shape)

    specs = {k: (None if k == "pos" else {n: one(t) for n, t in v.items()})
             for k, v in state.items()}
    return specs, state


def serve_state_shardings(cfg: ModelConfig, mesh, rules: Dict[str, Any],
                          B: int, S_max: int):
    """``(placements, state)``: `serve_state_specs` as DTensor
    placements on ``mesh``."""
    specs, state = serve_state_specs(cfg, mesh, rules, B, S_max)
    return {k: (None if v is None else
                {n: placements(sp, mesh) for n, sp in v.items()})
            for k, v in specs.items()}, state


@contextlib.contextmanager
def _sharded(mesh, rules):
    """The context of a step made with a mesh; nothing without one."""
    if mesh is None:
        yield
        return
    with axis_rules(mesh, rules or shd.FSDP_RULES), sharded_ops():
        yield


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


def make_train_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                    mesh=None, rules: Optional[Dict[str, Any]] = None, *,
                    remat: bool = True, accum_steps: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    loss's metrics plus ``loss``, ``grad_norm`` and ``lr``. With
    ``mesh`` (and ``rules``, default FSDP) the step runs sharded on a
    state of DTensors.

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
        with _sharded(mesh, rules):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: Dict[str, Tensor]):
        model = state.params
        if accum_steps == 1:
            loss, metrics, grads = loss_and_grads(model, batch, remat)
        else:
            B = batch["tokens"].shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum_steps} microbatches")
            mb = B // accum_steps
            dev = model.device
            g_acc = {k: torch.zeros_like(p, dtype=torch.float32)
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


def make_eval_step(cfg: ModelConfig, mesh=None,
                   rules: Optional[Dict[str, Any]] = None):
    """Returns ``eval_step(params, batch) -> metrics``: the loss's
    metrics plus ``loss``, without remat or autograd (sharded with
    ``mesh``)."""

    def eval_step(params, batch: Dict[str, Tensor]):
        if params.cfg != cfg:
            raise ValueError(f"eval step made for {cfg.name} was given a "
                             f"model of {params.cfg.name}")
        with torch.no_grad(), _sharded(mesh, rules):
            loss, metrics = mdl.loss_fn(params, batch, remat=False)
        return dict(metrics, loss=loss)

    return eval_step


def make_serve_fns(cfg: ModelConfig, mesh=None,
                   rules: Optional[Dict[str, Any]] = None):
    """Returns ``(prefill_fn, decode_fn)`` (sharded with ``mesh``):

    - ``prefill_fn(params, batch, state) -> (logits, state, memory)``;
    - ``decode_fn(params, token, state, cross_memory=None) -> (logits,
      state)``;

    where ``params`` is the `repro_torch.models.LM` built for ``cfg``.
    Both run under ``torch.inference_mode()`` (``no_grad`` with a mesh)
    and write the state's caches in place."""

    def _check(params):
        if params.cfg != cfg:
            raise ValueError(f"serve fns made for {cfg.name} were given "
                             f"a model of {params.cfg.name}")

    def prefill_fn(params, batch, state):
        _check(params)
        if mesh is None:
            return params.prefill(batch, state)
        with torch.no_grad(), _sharded(mesh, rules):
            return params.prefill_body(batch, state)

    def decode_fn(params, token, state, cross_memory=None):
        _check(params)
        if mesh is None:
            return params.decode_step(token, state, cross_memory)
        with torch.no_grad(), _sharded(mesh, rules):
            return params.decode_body(token, state, cross_memory)

    return prefill_fn, decode_fn
