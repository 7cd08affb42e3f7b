"""The arguments of every (arch x shape) dry-run cell as fake DTensors:
each carries its global shape and its placements on the mesh, and its
local shard is a fake tensor of the cell's ``FakeTensorMode``. Nothing
is allocated here."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models import model as mdl
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.dtensor import fake_dtensor, shard_module_
from repro_torch.train import trainer


@dataclasses.dataclass
class Cell:
    arch: str
    shape: cfgbase.ShapeSpec
    kind: str                     # train | prefill | decode
    step_name: str                # train_step | prefill | decode_step
    args: Tuple[Any, ...]         # fake DTensor trees
    in_shardings: Tuple[Any, ...]  # their placements
    config: ModelConfig
    fake_mode: Any = None         # the mode of the args' local shards


def _batch_specs(cfg: ModelConfig, B: int, S: int, kind: str
                 ) -> Dict[str, torch.Tensor]:
    """The batch of a step on the ``meta`` device."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    batch: Dict[str, Any] = {"tokens": meta((B, S), torch.int32)}
    if kind == "train":
        batch["labels"] = meta((B, S), torch.int32)
    if cfg.family == "vision":
        batch["image_embeds"] = meta((B, cfg.n_image_tokens, cfg.d_model),
                                     torch.bfloat16)
    if cfg.family == "encdec":
        batch["audio_embeds"] = meta((B, cfg.n_audio_tokens, cfg.d_model),
                                     torch.bfloat16)
    return batch


def _mem_specs(cfg: ModelConfig, B: int) -> Optional[torch.Tensor]:
    """Cross memory carried from prefill into decode (``meta``)."""
    if cfg.family == "vision":
        return torch.empty((B, cfg.n_image_tokens, cfg.d_model),
                           dtype=cfg.dtype, device="meta")
    if cfg.family == "encdec":
        return torch.empty((B, cfg.n_audio_tokens, cfg.d_model),
                           dtype=cfg.dtype, device="meta")
    return None


OPT_OVERRIDES = dict(attn_chunk=512, loss_chunk=512, gqa_grouped=True,
                     remat_policy="nothing")

# variant -> (config overrides, gradient-accumulation steps)
VARIANTS = {
    "baseline": ({}, 1),
    "opt": (OPT_OVERRIDES, 1),
    "opt_sub": (dict(OPT_OVERRIDES, remat_policy="sublayer"), 1),
    "opt_acc4": (dict(OPT_OVERRIDES, remat_policy="sublayer"), 4),
    "opt_acc4n": (OPT_OVERRIDES, 4),
    "opt_acc8n": (OPT_OVERRIDES, 8),
    "opt_acc8n_bf16s": (OPT_OVERRIDES, 8),
}


def apply_variant(cfg, variant: str):
    over, _ = VARIANTS[variant]
    return dataclasses.replace(cfg, **over) if over else cfg


def variant_accum(variant: str) -> int:
    return VARIANTS[variant][1]


def make_cell(arch: str, shape_name: str, mesh, *,
              rules: Optional[Dict[str, Any]] = None,
              ocfg: Optional[adamw.AdamWConfig] = None,
              smoke: bool = False, variant: str = "baseline",
              fake_mode=None, n_layers: Optional[int] = None) -> Cell:
    """The cell's arguments on ``mesh`` (a ``DeviceMesh`` of the open
    process group) as fake DTensors of ``fake_mode`` (a new
    ``FakeTensorMode`` by default) on the mesh's device type. ``smoke``:
    the reduced config at batch 2, sequence 16; ``n_layers``: the depth
    cut to that many layers."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    spec = cfgbase.get(arch)
    cfg = apply_variant(spec.smoke if smoke else spec.config, variant)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=int(n_layers))
    shape = cfgbase.SHAPE_BY_NAME[shape_name]
    reason = spec.skip_reason(shape_name)
    if reason:
        raise cfgbase.SkipCell(reason)
    rules = rules or shd.FSDP_RULES
    ocfg = ocfg or adamw.AdamWConfig(
        master_copy=cfg.param_dtype == torch.bfloat16,
        state_dtype=torch.bfloat16 if variant.endswith("bf16s")
        else torch.float32)
    fake_mode = fake_mode or FakeTensorMode()
    B, S = shape.global_batch, shape.seq_len
    if smoke:
        B, S = 2, 16

    def fake(t, pl, dtype=None):
        return fake_dtensor(t.shape, dtype or t.dtype, mesh, pl, fake_mode)

    def batched(tree):
        sh = trainer.batch_shardings(mesh, rules, tree)
        return {k: fake(x, sh[k]) for k, x in tree.items()}, sh

    model = mdl.abstract_params(cfg)
    p_sh = shd.resolve_params(model.param_axes(), mesh, rules,
                              dict(model.named_parameters()))
    shard_module_(model, lambda k, p: fake(p, p_sh[k]))

    if shape.kind == "train":
        ts_sh = trainer.state_shardings(cfg, ocfg, mesh, rules)
        named = dict(model.named_parameters())

        def like(dtype):
            return {k: fake(p, p_sh[k], dtype) for k, p in named.items()}

        opt = adamw.OptState(
            step=fake(torch.empty((), dtype=torch.int32), ts_sh.opt.step),
            mu=like(ocfg.state_dtype), nu=like(ocfg.state_dtype),
            master=like(torch.float32) if ocfg.master_copy else None)
        batch, b_sh = batched(_batch_specs(cfg, B, S, "train"))
        return Cell(arch=arch, shape=shape, kind="train",
                    step_name="train_step",
                    args=(trainer.TrainState(params=model, opt=opt), batch),
                    in_shardings=(ts_sh, b_sh), config=cfg,
                    fake_mode=fake_mode)

    st_sh, st = trainer.serve_state_shardings(cfg, mesh, rules, B, S)
    state = {k: (v if st_sh[k] is None else
                 {n: fake(t, st_sh[k][n]) for n, t in v.items()})
             for k, v in st.items()}

    if shape.kind == "prefill":
        batch, b_sh = batched(_batch_specs(cfg, B, S, "prefill"))
        return Cell(arch=arch, shape=shape, kind="prefill",
                    step_name="prefill", args=(model, batch, state),
                    in_shardings=(p_sh, b_sh, st_sh), config=cfg,
                    fake_mode=fake_mode)

    # decode: one new token against a seq_len-deep cache
    token, t_sh = batched({"token": torch.empty((B, 1), dtype=torch.int32,
                                                device="meta")})
    args: Tuple[Any, ...] = (model, token["token"], state)
    shards: Tuple[Any, ...] = (p_sh, t_sh["token"], st_sh)
    mem = _mem_specs(cfg, B)
    if mem is not None:
        m, m_sh = batched({"mem": mem})
        args = args + (m["mem"],)
        shards = shards + (m_sh["mem"],)
    return Cell(arch=arch, shape=shape, kind="decode",
                step_name="decode_step", args=args, in_shardings=shards,
                config=cfg, fake_mode=fake_mode)


def cell_step_fn(cell: Cell, mesh, rules: Optional[Dict[str, Any]] = None,
                 ocfg: Optional[adamw.AdamWConfig] = None,
                 accum_steps: int = 1):
    """The step of ``cell`` made with ``mesh`` and ``rules``."""
    rules = rules or shd.FSDP_RULES
    cfg = cell.config
    ocfg = ocfg or adamw.AdamWConfig(
        master_copy=cfg.param_dtype == torch.bfloat16)
    if cell.kind == "train":
        return trainer.make_train_step(cfg, ocfg, mesh, rules,
                                       accum_steps=accum_steps)
    prefill_fn, decode_fn = trainer.make_serve_fns(cfg, mesh, rules)
    return prefill_fn if cell.kind == "prefill" else decode_fn
