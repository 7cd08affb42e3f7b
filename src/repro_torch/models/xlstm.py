"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential), the ``xlstm-125m`` mixers.

mLSTM follows the parallel formulation inside chunks (linear attention
with exponential input gates and cumulative forget-gate decay,
log-space stabilised), carrying the matrix memory ``C [B, H, hd, hd]``,
the normaliser ``n [B, H, hd]`` and the stabiliser ``m [B, H]`` across
chunks. Its output depends on where the chunks are cut (the normaliser
clamp ``max(|q·n|, 1)`` acts on stabilised quantities), so the chunks
are cut exactly as the reference cuts them: ``ch = min(ssm_chunk, S)``
and a tail padded with ``logi = -1e30``. sLSTM runs step by step.
Both decode from an O(1) state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (ModelConfig, ParamFactory,
                                       einsum_batched, remat_call)
from repro_torch.models.layers import _f32_sqrt

Tensor = torch.Tensor


# ------------------------------------------------------------- mLSTM

def _mlstm_chunk(C, n, m, qc, kc, vc, lic, lfc):
    """One chunk: carry (C, n, m) in, (C', n', m') and y [B,ch,H,hd]
    (f32) out."""
    ch = qc.shape[1]
    # cumulative log-forget within the chunk (inclusive)
    Fc = torch.cumsum(lfc, dim=1)                        # [B, ch, H]
    # stabiliser: running max of (input-gate + future-decay) terms
    a = lic + Fc
    m_new = torch.maximum(m + Fc[:, -1], torch.amax(a, dim=1) - 0.0)
    # intra-chunk pairwise decay D[t, τ] = F_t − F_τ (τ ≤ t)
    Dmat = Fc[:, :, None, :] - Fc[:, None, :, :]         # [B,ch,ch,H]
    tri = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                device=qc.device))
    logw = torch.where(tri[None, :, :, None], Dmat + lic[:, None, :, :],
                       -torch.inf)
    w = torch.exp(logw - m_new[:, None, None, :])        # [B,ch,ch,H]
    scores = einsum_batched("bthk,bwhk->btwh", qc, kc).float()
    qf, kf, vf = qc.float(), kc.float(), vc.float()
    intra = einsum_batched("btwh,btwh,bwhk->bthk", scores, w, vf)
    inter_scale = torch.exp(Fc + m[:, None] - m_new[:, None])
    inter = einsum_batched("bthk,bhkl,bth->bthl", qf, C, inter_scale)
    # normaliser |q·n| with the same intra/inter decomposition
    nz_intra = einsum_batched("btwh,btwh->bth", scores, w)
    nz_inter = einsum_batched("bthk,bhk,bth->bth", qf, n, inter_scale)
    den = torch.abs(nz_intra + nz_inter)
    y = (intra + inter) / torch.clamp(den, min=1.0)[..., None]
    # carry: C' = exp(F_T) C + Σ_τ exp(F_T − F_τ + i_τ) k v^T
    decay_all = torch.exp(Fc[:, -1:, :] - Fc + lic - m_new[:, None])
    keep = torch.exp(Fc[:, -1] + m - m_new)
    C_new = keep[..., None, None] * C + einsum_batched(
        "bthk,bth,bthl->bhkl", kf, decay_all, vf)
    n_new = keep[..., None] * n + einsum_batched("bthk,bth->bhk", kf,
                                               decay_all)
    return C_new, n_new, m_new, y


class MLSTM(nn.Module):
    """``wqkv [d, 3, H, hd]``, ``wif [d, 2, H]``, ``wo [H, hd, d]``,
    ``ogate [d, H, hd]``."""

    def __init__(self, pf: ParamFactory):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        self.wqkv = pf.add((d, 3, H, hd),
                           ("d_model", "gate3", "q_heads", "head_dim"))
        self.wif = pf.add((d, 2, H), ("d_model", "gate2", "q_heads"),
                          init="zeros")
        self.wo = pf.add((H, hd, d), ("q_heads", "head_dim", "d_model"))
        self.ogate = pf.add((d, H, hd), ("d_model", "q_heads", "head_dim"))

    def forward(self, x: Tensor, *,
                state: Optional[Dict[str, Tensor]] = None,
                ) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
        """x: [B, S, d]; ``state`` = {"C", "n", "m"} for decode."""
        cfg = self.cfg
        dt = cfg.dtype
        B, S, d = x.shape
        H, hd = cfg.n_heads, cfg.hd
        qkv = torch.einsum("bsd,dghk->bsghk", x, self.wqkv.to(dt))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B,S,H,hd]
        # sqrt(hd) in f32, rounded to the activation dtype (a host scalar)
        k = k / float(torch.tensor(_f32_sqrt(hd)).to(dt))
        gates = torch.einsum("bsd,dgh->bsgh", x, self.wif.to(dt))
        logi = gates[:, :, 0].float()                       # [B, S, H]
        logf = F.logsigmoid(gates[:, :, 1].float() + 4.0)

        ch = min(cfg.ssm_chunk, S)
        pad = (-S) % ch
        if pad:
            # identity-extend: f-gate 1 (log 0) keeps state, i-gate −inf
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
            logf = F.pad(logf, (0, 0, 0, pad))
        nc = (S + pad) // ch

        if state is None:
            C = torch.zeros((B, H, hd, hd), device=x.device)
            n = torch.zeros((B, H, hd), device=x.device)
            m = torch.zeros((B, H), device=x.device)
        else:
            C, n, m = state["C"], state["n"], state["m"]
        ys = []
        for i in range(nc):
            sl = slice(i * ch, (i + 1) * ch)
            args = (C, n, m, q[:, sl], k[:, sl], v[:, sl], logi[:, sl],
                    logf[:, sl])
            # under autograd each chunk is rematerialised in the
            # backward pass (the reference's checkpoint saving nothing)
            C, n, m, y = (remat_call(_mlstm_chunk, "nothing", *args)
                          if torch.is_grad_enabled()
                          else _mlstm_chunk(*args))
            ys.append(y)
        y = torch.cat(ys, dim=1)[:, :S].to(dt)
        og = torch.sigmoid(torch.einsum("bsd,dhk->bshk", x,
                                        self.ogate.to(dt)))
        out = torch.einsum("bshk,hkd->bsd", y * og, self.wo.to(dt))
        new_state = None if state is None else {"C": C, "n": n, "m": m}
        return out.to(dt), new_state


def init_mlstm_state(cfg: ModelConfig, B: int,
                     device=None) -> Dict[str, Tensor]:
    H, hd = cfg.n_heads, cfg.hd
    return {"C": torch.zeros((B, H, hd, hd), device=device),
            "n": torch.zeros((B, H, hd), device=device),
            "m": torch.zeros((B, H), device=device)}


# ------------------------------------------------------------- sLSTM

class SLSTM(nn.Module):
    """``wx [d, 4, H, hd]``, ``wr [H, hd, 4, hd]`` (normal × 0.01),
    ``wo [H, hd, d]``."""

    def __init__(self, pf: ParamFactory):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        self.wx = pf.add((d, 4, H, hd),
                         ("d_model", "gate4", "q_heads", "head_dim"))
        self.wr = pf.add((H, hd, 4, hd),
                         ("q_heads", "head_dim", "gate4", "head_dim2"),
                         scale=0.01)
        self.wo = pf.add((H, hd, d), ("q_heads", "head_dim", "d_model"))

    def forward(self, x: Tensor, *,
                state: Optional[Dict[str, Tensor]] = None,
                ) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
        """Sequential sLSTM; ``state`` = {"c", "n", "h"} for decode."""
        cfg = self.cfg
        dt = cfg.dtype
        B, S, d = x.shape
        H, hd = cfg.n_heads, cfg.hd
        zx = torch.einsum("bsd,dghk->bsghk", x, self.wx.to(dt)).float()
        wr = self.wr.float()
        if state is None:
            zeros = torch.zeros((B, H, hd), device=x.device)
            c, n, h = zeros, zeros, zeros
        else:
            c, n, h = state["c"], state["n"], state["h"]
        hs = []
        for t in range(S):
            zt = zx[:, t]
            rec = einsum_batched("bhk,hkgl->bghl", h, wr)
            z, i, f, o = (zt[:, g] + rec[:, g] for g in range(4))
            ig = torch.exp(torch.clamp(i, max=10.0))   # stabilised exp gate
            fg = torch.sigmoid(f + 1.0)
            c = fg * c + ig * torch.tanh(z)
            n = fg * n + ig
            h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
            hs.append(h)
        y = torch.stack(hs, dim=1).to(dt)               # [B, S, H, hd]
        out = torch.einsum("bshk,hkd->bsd", y, self.wo.to(dt))
        new_state = None if state is None else {"c": c, "n": n, "h": h}
        return out, new_state


def init_slstm_state(cfg: ModelConfig, B: int,
                     device=None) -> Dict[str, Tensor]:
    H, hd = cfg.n_heads, cfg.hd
    return {k: torch.zeros((B, H, hd), device=device)
            for k in ("c", "n", "h")}
