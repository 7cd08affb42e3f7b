"""Top-k routed Mixture-of-Experts FFN (capacity-based dispatch).

GShard-style einsum dispatch with token groups: tokens are split into
groups of ``MOE_GROUP``; each group routes its tokens to a per-group
expert capacity ``C = group·k·cf/E``, and a token past an expert's
capacity is dropped. The dispatch/combine one-hots are built by a
K-step accumulation, so the peak intermediate is ``[G, Sg, E, C]``.

Every step mirrors the reference exactly, since which tokens drop
depends on token order: the running occupancy is a cumulative sum over
the group, one accumulation step per choice k, and top-k puts the lower
expert index first on a tie (a stable descending sort; router logits
are computed in ``cfg.dtype``, where ties are common).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (ModelConfig, ParamFactory,
                                       einsum_batched)

Tensor = torch.Tensor

MOE_GROUP = 1024          # tokens per routing group


def group_capacity(cfg: ModelConfig, group: int) -> int:
    c = int(group * cfg.moe_topk * cfg.capacity_factor
            / cfg.moe_experts) + 1
    return max(4, -(-c // 4) * 4)                 # multiple of 4


def top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, in
    descending order, a lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(i: Tensor, n: int, dtype) -> Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero
    row."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


class MoE(nn.Module):
    """``router [d, E]``, ``wi [E, d, 2|1, f]``, ``wo [E, f, d]``."""

    #: the per-expert parameters (`ModelConfig.active_param_count`
    #: counts k of E of them per token)
    EXPERT_PARAMS = ("wi", "wo")

    def __init__(self, pf: ParamFactory):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
        self.router = pf.add((d, E), ("d_model", "experts_r"))
        g = 2 if cfg.act == "swiglu" else 1
        self.wi = pf.add((E, d, g, f),
                         ("experts", "d_model", "gate2", "ff"))
        self.wo = pf.add((E, f, d), ("experts", "ff", "d_model"))

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """x: [B, S, d] → (out [B, S, d], aux load-balancing loss [])."""
        cfg = self.cfg
        dt = cfg.dtype
        B, S, d = x.shape
        E, K = cfg.moe_experts, cfg.moe_topk
        T = B * S
        Sg = min(MOE_GROUP, T)
        if T % Sg:
            raise ValueError(f"MoE: {T} tokens do not split into groups "
                             f"of {Sg}")
        G = T // Sg
        C = group_capacity(cfg, Sg)
        xt = x.reshape(G, Sg, d)

        logits = torch.einsum("gsd,de->gse", xt, self.router.to(dt))
        probs = torch.softmax(logits.float(), dim=-1)
        gate_v, gate_i = top_k(probs, K)                  # [G, Sg, K]
        gate_v = gate_v / torch.sum(gate_v, dim=-1, keepdim=True)

        # auxiliary load-balance loss (Switch §4): E · Σ_e f_e · P_e
        me = torch.mean(probs, dim=(0, 1))
        ce = torch.mean(torch.sum(_one_hot(gate_i, E, torch.float32),
                                  dim=2), dim=(0, 1))
        aux = E * torch.sum(me * ce)

        # per-(group, expert) running occupancy, one step per choice k
        dispatch = torch.zeros((G, Sg, E, C), dtype=dt, device=x.device)
        combine = torch.zeros((G, Sg, E, C), dtype=dt, device=x.device)
        used = torch.zeros((G, E), dtype=torch.int32, device=x.device)
        for k in range(K):
            oh = _one_hot(gate_i[..., k], E, torch.int32)   # [G,Sg,E]
            pos = used[:, None, :] + torch.cumsum(oh, dim=1,
                                                  dtype=torch.int32) - oh
            keep = (pos < C) & (oh > 0)
            mask_k = (oh * keep).to(dt)                   # [G, Sg, E]
            # one_hot(pos >= C) is all-zero: overflowing tokens drop out
            d_k = mask_k[..., None] * _one_hot(pos, C, dt)
            dispatch = dispatch + d_k
            combine = combine + d_k * gate_v[..., k, None, None].to(dt)
            used = used + torch.sum(oh, dim=1, dtype=torch.int32)

        xin = einsum_batched("gsec,gsd->egcd", dispatch, xt)  # [E, G, C, d]
        h = einsum_batched("egcd,edif->egcif", xin, self.wi.to(dt))
        if cfg.act == "swiglu":
            h = F.silu(h[..., 0, :]) * h[..., 1, :]
        else:
            h = F.gelu(h[..., 0, :], approximate="tanh")
        xout = einsum_batched("egcf,efd->egcd", h, self.wo.to(dt))
        out = einsum_batched("gsec,egcd->gsd", combine, xout)
        return out.reshape(B, S, d), aux
