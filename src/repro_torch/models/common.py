"""Model configuration and parameter initialisation shared by every
family.

`ModelConfig` has the reference's fields and defaults; ``dtype`` (the
activation and compute dtype) and ``param_dtype`` are torch dtypes.
Parameters are stored in ``param_dtype`` (f32) and activations are
``dtype`` (bf16 by default), as in the reference.

`ParamFactory` creates every parameter with the reference's per-layer
shape and logical axis names (``("d_model", "q_heads", "head_dim")``:
`repro_torch.parallel.sharding` maps them to mesh axes) and initialises
it: ``normal × scale`` (0.02 unless a layer says
otherwise), ``ones`` or ``zeros``, drawn from one explicit
``torch.Generator`` in the order the modules are built. The values are
not ``jax.random``'s: weights carried across from the reference go
through ``repro_torch.interop.lm_params`` instead. On the ``meta``
device nothing is drawn or allocated, which is how `param_count` and
`active_param_count` size the 398B configuration.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                  create_selective_checkpoint_contexts)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # decoder | encdec | vision | xlstm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # ---- MoE ----
    moe_experts: int = 0
    moe_topk: int = 0
    moe_every: int = 1            # FFN is MoE on layers with i % every == off
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # ---- hybrid (jamba) ----
    attn_every: int = 0           # layer i is attention iff i%every == off
    attn_offset: int = 0
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # ---- vision (llama-3.2-vision) ----
    cross_attn_every: int = 0     # i % every == off → cross-attn layer
    cross_attn_offset: int = 0
    n_image_tokens: int = 1024
    # ---- xLSTM ----
    slstm_period: int = 0         # within a period, last layer is sLSTM
    # ---- enc-dec (whisper) ----
    enc_layers: int = 0
    n_audio_tokens: int = 1500
    # ---- common ----
    head_dim: int = 0             # 0 → d_model // n_heads
    act: str = "swiglu"           # swiglu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    rope_theta: float = 10_000.0  # > 0 rope; 0 sinusoidal; < 0 neither
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16   # activation/compute dtype
    param_dtype: Any = torch.float32
    # ---- perf knobs (0 = the paper-faithful baseline) ----
    attn_chunk: int = 0           # >0: online-softmax over KV chunks
    loss_chunk: int = 0           # >0: chunked cross-entropy over seq
    gqa_grouped: bool = False     # grouped einsum instead of KV repeat
    remat_policy: str = "dots"    # dots | nothing (layer-group remat)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def is_moe_layer(self, i) -> bool:
        if self.moe_experts == 0:
            return False
        return i % self.moe_every == self.moe_offset

    def is_attn_layer(self, i) -> bool:
        if self.attn_every == 0:
            return True
        return i % self.attn_every == self.attn_offset

    def is_cross_layer(self, i) -> bool:
        if self.cross_attn_every == 0:
            return False
        return i % self.cross_attn_every == self.cross_attn_offset

    def is_slstm_layer(self, i) -> bool:
        if self.slstm_period == 0:
            return False
        return i % self.slstm_period == self.slstm_period - 1

    def param_count(self) -> int:
        """Total parameters (exact, from the model built on the meta
        device: nothing is allocated)."""
        from repro_torch.models.model import abstract_params
        return sum(p.numel() for p in abstract_params(self).parameters())

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k of E experts)."""
        from repro_torch.models.model import abstract_params
        from repro_torch.models.moe import MoE
        model = abstract_params(self)
        total = sum(p.numel() for p in model.parameters())
        for mod in model.modules():
            if isinstance(mod, MoE):
                for name in MoE.EXPERT_PARAMS:
                    size = getattr(mod, name).numel()
                    total -= size - size * self.moe_topk // max(
                        1, self.moe_experts)
        return total


class ParamFactory:
    """Creates and initialises parameters on ``device`` in
    ``cfg.param_dtype``; ``normal`` leaves are drawn from
    ``generator`` (a ``torch.Generator`` on ``device``). On the
    ``meta`` device the parameters are shapes only."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = generator

    def add(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
            init: str = "normal", scale: float = 0.02) -> nn.Parameter:
        """A parameter of ``shape`` whose dimensions carry the logical
        ``axes`` (the reference's per-layer names, without its leading
        ``"layers"``), kept on the parameter as ``logical_axes``."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in "
                             f"rank")
        kw = dict(dtype=self.cfg.param_dtype, device=self.device)
        if self.device.type == "meta":
            arr = torch.empty(shape, **kw)
        elif init == "zeros":
            arr = torch.zeros(shape, **kw)
        elif init == "ones":
            arr = torch.ones(shape, **kw)
        else:
            arr = torch.randn(shape, generator=self.generator, **kw)
            arr.mul_(scale)
        param = nn.Parameter(arr)
        param.logical_axes = tuple(axes)
        return param


#: the products a ``"dots"`` remat keeps, outside `einsum_batched`:
#: linear maps and ``matmul``s of a stack by a matrix reach the
#: dispatcher as ``mm``/``addmm``, einsums as ``bmm`` (of batch 1 when
#: they have no batch dims)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)
#: set while `einsum_batched` runs
_BATCH_DIMS = contextvars.ContextVar("repro_torch_batch_dims",
                                     default=False)


class _BatchDims:
    def __enter__(self):
        self.token = _BATCH_DIMS.set(True)

    def __exit__(self, *exc):
        _BATCH_DIMS.reset(self.token)


def einsum_batched(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of a product with batch dims (attention's scores
    and P.V, the MoE's dispatch, experts and combine, the scans' chunk
    products). A ``"dots"`` remat recomputes it at any batch extent: by
    its op alone it could not tell it from a product without batch dims,
    which also reaches the dispatcher as a ``bmm`` of batch 1."""
    with _BatchDims():
        return torch.einsum(equation, *operands)


def _save_dots(ctx, op, *args, **kwargs):
    keep = op in _DOTS and not _BATCH_DIMS.get()
    return (CheckpointPolicy.MUST_SAVE if keep
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(fn, policy: str, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its internals are
    recomputed in the backward pass, except, when ``policy == "dots"``,
    the outputs of the products without batch dims (every matrix
    product outside `einsum_batched`), as the reference's
    ``dots_with_no_batch_dims_saveable`` keeps them; ``"nothing"`` keeps
    none. The values are ``fn``'s own."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, **kw)
