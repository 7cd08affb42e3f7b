"""Layer-stack assembly for every decoder-style family.

The repeating layer pattern (period ``P`` = lcm of the attention, MoE,
cross-attention and sLSTM periodicities) forms one group; a stack is
``G = n_layers / P`` groups of ``P`` sub-layer slots ``blk{j}``, run
in order (the reference's scan over groups, written as a loop). A
parameter of slot j in group g is ``groups[g].blk{j}.<leaf>``, the
reference's ``<prefix>/blk{j}/<leaf>[g]``.

Families: ``decoder`` (dense/MoE), ``vision`` (interleaved gated
cross-attention), ``hybrid`` (Jamba: Mamba + periodic attention +
alternating MoE), ``xlstm`` (mLSTM/sLSTM) and the ``encdec`` decoder
(self-attention, then cross-attention in every layer).

Decode state is a dict shaped like the reference's: ``"pos"`` (an int)
and, per slot, that slot's state stacked ``[G, ...]``. `Stack.run`
writes the new state into those tensors in place and returns the dict
with ``pos`` advanced; a vision cross layer's cache passes through
untouched.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as ly
from repro_torch.models import mamba as mb
from repro_torch.models import xlstm as xl
from repro_torch.models.common import (ModelConfig, ParamFactory,
                                       remat_call)
from repro_torch.models.moe import MoE
from repro_torch.parallel.logical import constrain

Tensor = torch.Tensor


def period(cfg: ModelConfig) -> int:
    p = 1
    for x in (cfg.attn_every, cfg.moe_every, cfg.cross_attn_every,
              cfg.slstm_period):
        if x:
            p = math.lcm(p, x)
    return p


def layer_kind(cfg: ModelConfig, j: int) -> str:
    """Kind of sub-layer j within a group (j ≡ global index mod P)."""
    if cfg.family == "xlstm":
        return "slstm" if cfg.is_slstm_layer(j) else "mlstm"
    if cfg.family == "hybrid" and not cfg.is_attn_layer(j):
        return "mamba"
    if cfg.family == "vision" and cfg.is_cross_layer(j):
        return "cross"
    return "attn"


def ffn_kind(cfg: ModelConfig, j: int) -> str:
    if cfg.d_ff == 0:
        return "none"
    return "moe" if cfg.is_moe_layer(j) else "mlp"


#: the mixer module of each layer kind, under its reference name
_MIXERS = {"attn": ("attn", ly.Attention), "cross": ("attn", ly.Attention),
           "mamba": ("mamba", mb.Mamba), "mlstm": ("mlstm", xl.MLSTM),
           "slstm": ("slstm", xl.SLSTM)}


class Block(nn.Module):
    """One sub-layer slot: ``ln1`` and its mixer, with ``with_cross``
    ``lnx`` and ``xattn``, then ``ln2`` and the FFN (``moe`` or
    ``mlp``) unless ``d_ff == 0``."""

    def __init__(self, pf: ParamFactory, j: int, with_cross: bool):
        super().__init__()
        cfg = pf.cfg
        self.kind = layer_kind(cfg, j)
        self.ffn = ffn_kind(cfg, j)
        self.ln1 = ly.Norm(pf, cfg.d_model)
        name, cls = _MIXERS[self.kind]
        self.mixer_name = name
        if self.kind == "cross":
            self.add_module(name, cls(pf, cross=True))
        else:
            self.add_module(name, cls(pf))
        if with_cross:
            self.lnx = ly.Norm(pf, cfg.d_model)
            self.xattn = ly.Attention(pf)
        if self.ffn != "none":
            self.ln2 = ly.Norm(pf, cfg.d_model)
        if self.ffn == "moe":
            self.moe = MoE(pf)
        elif self.ffn == "mlp":
            self.mlp = ly.MLP(pf)


class Stack(nn.Module):
    """``groups[g]["blk{j}"]``: G groups of the P-slot pattern."""

    def __init__(self, pf: ParamFactory, n_layers: int,
                 with_cross: bool = False):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        P = period(cfg)
        if n_layers % P:
            raise ValueError(f"{n_layers} layers are not whole groups of "
                             f"{P}")
        self.with_cross = with_cross
        self.groups = nn.ModuleList(
            nn.ModuleDict({f"blk{j}": Block(pf, j, with_cross)
                           for j in range(P)})
            for _ in range(n_layers // P))

    def run(self, x: Tensor, *, causal: bool = True,
            cross_memory: Optional[Tensor] = None,
            decode_state: Optional[Dict[str, Any]] = None,
            remat: bool = False,
            ) -> Tuple[Tensor, Tensor, Optional[Dict[str, Any]]]:
        """Returns (hidden, MoE aux loss, new decode state). The aux
        loss is summed a group, then over the groups, as the
        reference's scan sums it. ``remat`` (training only: ignored
        with a decode state or without autograd) recomputes in the
        backward pass what ``cfg.remat_policy`` does not keep:
        ``"dots"`` keeps each group's matrix products, ``"nothing"``
        keeps only the group's input, ``"sublayer"`` is ``"dots"`` with
        each sub-layer checkpointed inside the group (keeping nothing),
        so a group's backward holds one sub-layer's internals at a
        time. No value changes."""
        S_in = x.shape[1]
        pos0 = decode_state["pos"] if decode_state is not None else None
        policy = (self.cfg.remat_policy
                  if remat and decode_state is None
                  and torch.is_grad_enabled() else None)
        auxs = []
        for g, group in enumerate(self.groups):
            st = (None if decode_state is None else
                  dict({name: {k: t[g] for k, t in
                               decode_state[name].items()}
                        for name in group}, pos=pos0))
            if policy is None:
                x, aux = self._group(group, x, st, causal, cross_memory,
                                     False)
            else:
                x, aux = remat_call(
                    self._group, "nothing" if policy == "nothing"
                    else "dots", group, x, st, causal, cross_memory,
                    policy == "sublayer")
            auxs.append(aux)
        new_state = None
        if decode_state is not None:
            new_state = dict(decode_state, pos=pos0 + S_in)
        return x, torch.sum(torch.stack(auxs)), new_state

    def _group(self, group: nn.ModuleDict, x: Tensor,
               states: Optional[Dict[str, Any]],
               causal: bool, cross_memory: Optional[Tensor],
               sublayer: bool) -> Tuple[Tensor, Tensor]:
        """One group's P slots; a slot's decode state (``states``, with
        the stack's ``"pos"``) is written in place. ``sublayer``
        checkpoints each sub-layer, keeping nothing."""
        cfg = self.cfg
        use_rope = cfg.rope_theta > 0

        def call(fn, *args):
            # every operand passes as an argument: a recompute in the
            # backward pass must not read this loop's later variables
            return (remat_call(fn, "nothing", *args) if sublayer
                    else fn(*args))

        aux_total = torch.zeros((), device=x.device)
        for name, blk in group.items():
            st_in = None if states is None else states[name]
            mixer = getattr(blk, blk.mixer_name)
            h = blk.ln1(x)
            if blk.kind in ("attn", "cross"):
                src = cross_memory if blk.kind == "cross" else None
                if st_in is None:
                    h = call(_attn_out, mixer, h, src, causal, use_rope)
                else:
                    # the cache's K/V are written in place
                    h, _ = mixer(h, kv_src=src, causal=causal,
                                 use_rope=use_rope,
                                 cache=dict(st_in, pos=states["pos"]))
            elif st_in is None:
                h = call(_mixer_out, mixer, h)
            else:
                h, st = mixer(h, state=st_in)
                for k, t in st.items():
                    st_in[k].copy_(t)
            x = x + h
            if self.with_cross:
                h = blk.lnx(x)
                h = call(_attn_out, blk.xattn, h, cross_memory, False,
                         False)
                x = x + h
            if blk.ffn == "moe":
                h, aux = call(blk.moe, blk.ln2(x))
                aux_total = aux_total + aux
                x = x + h
            elif blk.ffn == "mlp":
                x = x + call(blk.mlp, blk.ln2(x))
            x = constrain(x, "batch", "seq", "embed")
        return x, aux_total


def _attn_out(attn: ly.Attention, h: Tensor, src: Optional[Tensor],
              causal: bool, use_rope: bool) -> Tensor:
    return attn(h, kv_src=src, causal=causal, use_rope=use_rope)[0]


def _mixer_out(mixer: nn.Module, h: Tensor) -> Tensor:
    return mixer(h)[0]


def init_decode_state(cfg: ModelConfig, n_layers: int, B: int,
                      S_max: int, device=None) -> Dict[str, Any]:
    """Stacked per-group decode state for every sub-layer slot."""
    P = period(cfg)
    G = n_layers // P
    state: Dict[str, Any] = {"pos": 0}

    def stack(tree):
        return {k: t.expand((G,) + t.shape).contiguous()
                for k, t in tree.items()}

    for j in range(P):
        kind = layer_kind(cfg, j)
        if kind in ("attn", "cross"):
            c = ly.init_cache(cfg, B, S_max, device)
            del c["pos"]
            state[f"blk{j}"] = stack(c)
        elif kind == "mamba":
            state[f"blk{j}"] = stack(mb.init_mamba_state(cfg, B, device))
        elif kind == "mlstm":
            state[f"blk{j}"] = stack(xl.init_mlstm_state(cfg, B, device))
        elif kind == "slstm":
            state[f"blk{j}"] = stack(xl.init_slstm_state(cfg, B, device))
    return state
