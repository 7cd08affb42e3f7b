"""Mamba-style selective SSM block (the Jamba hybrid's mixer).

The sequence is split into ``ssm_chunk``-length chunks processed in
order, carrying the SSM state; inside a chunk the linear recurrence
``h_t = ā_t ⊙ h_{t-1} + (dt·B·x)_t`` is a log-depth (Hillis-Steele)
scan over the chunk, exact in real arithmetic like the reference's
``associative_scan``. The discretised ``[B, S, d_inner, d_state]``
tensors never materialise over the whole sequence: the peak is
``[B, chunk, d_inner, d_state]``.

Decode is the same recurrence on the carried state ``[B, d_inner,
d_state]`` plus the conv tail of length ``ssm_conv - 1``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (ModelConfig, ParamFactory,
                                       einsum_batched, remat_call)

Tensor = torch.Tensor


def d_inner_of(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def _scan_chunk(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Inclusive scan of ``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)``
    along dim 1, by doubling: after it, ``a[t]`` is the product of
    ``a[0..t]`` and ``b[t]`` the recurrence's value from ``h = 0``."""
    n = a.shape[1]
    shift = 1
    while shift < n:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        a_cur, b_cur = a[:, shift:], b[:, shift:]
        a = torch.cat([a[:, :shift], a_cur * a_prev], dim=1)
        b = torch.cat([b[:, :shift], a_cur * b_prev + b_cur], dim=1)
        shift *= 2
    return a, b


def _ssm_scan_chunked(cfg: ModelConfig, dt: Tensor, bmat: Tensor,
                      c: Tensor, xc: Tensor, amat: Tensor, h0: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """dt/xc: [B, S, di]; bmat/c: [B, S, ds]; amat: [di, ds];
    h0: [B, di, ds] (f32). Returns (y [B, S, di] f32, h_final)."""
    B, S, di = dt.shape
    ch = min(cfg.ssm_chunk, S)
    pad = (-S) % ch
    if pad:
        # identity-extend: dt=0 ⇒ ā=1 keeps h and adds nothing; c=0
        dt, xc, bmat, c = (F.pad(t, (0, 0, 0, pad))
                           for t in (dt, xc, bmat, c))
    nc = (S + pad) // ch
    h = h0
    ys = []
    for i in range(nc):
        sl = slice(i * ch, (i + 1) * ch)
        args = (h, dt[:, sl], bmat[:, sl], c[:, sl], xc[:, sl], amat)
        # under autograd each chunk is rematerialised in the backward
        # pass (the reference's checkpoint saving nothing): the
        # per-chunk residuals drop to the [B, di, ds] carry
        h, y = (remat_call(_ssm_chunk, "nothing", *args)
                if torch.is_grad_enabled() else _ssm_chunk(*args))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def _ssm_chunk(h: Tensor, dtc: Tensor, bc: Tensor, cc: Tensor,
               xcc: Tensor, amat: Tensor) -> Tuple[Tensor, Tensor]:
    """One chunk from the carry ``h``: (h at its end, y [B, ch, di])."""
    dtf = dtc.float()
    ac = torch.exp(dtf[..., None] * amat[None, None])     # [B,ch,di,ds]
    bxc = (dtf * xcc.float())[..., None] * bc.float()[:, :, None, :]
    aa, bb = _scan_chunk(ac, bxc)
    hs = aa * h[:, None] + bb                             # [B,ch,di,ds]
    return hs[:, -1], einsum_batched("bcdz,bcz->bcd", hs, cc.float())


class Mamba(nn.Module):
    """``win [d, 2, di]``, ``conv [cw, di]``, ``wbc [di, 2, ds]``,
    ``wdt [di]``, ``alog [di, ds]``, ``dskip [di]``, ``wout [di, d]``."""

    def __init__(self, pf: ParamFactory):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        d, di, ds = cfg.d_model, d_inner_of(cfg), cfg.ssm_state
        self.win = pf.add((d, 2, di), ("d_model", "gate2", "ssm_i"))
        self.conv = pf.add((cfg.ssm_conv, di), ("conv", "ssm_i"))
        self.wbc = pf.add((di, 2, ds), ("ssm_i", "gate2", "ssm_s"))
        self.wdt = pf.add((di,), ("ssm_i",), init="zeros")
        self.alog = pf.add((di, ds), ("ssm_i", "ssm_s"), init="zeros")
        self.dskip = pf.add((di,), ("ssm_i",), init="ones")
        self.wout = pf.add((di, d), ("ssm_i", "d_model"))

    def forward(self, x: Tensor, *,
                state: Optional[Dict[str, Tensor]] = None,
                ) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
        """x: [B, S, d]. ``state`` = {"h": [B, di, ds] f32, "conv":
        [B, cw-1, di]} for incremental decode; the new state is
        returned (None without one)."""
        cfg = self.cfg
        dt_ = cfg.dtype
        B, S, d = x.shape
        di, ds, cw = d_inner_of(cfg), cfg.ssm_state, cfg.ssm_conv

        xz = torch.einsum("bsd,dgi->bsgi", x, self.win.to(dt_))
        xi, z = xz[..., 0, :], xz[..., 1, :]              # [B, S, di]

        # causal depthwise conv over the sequence
        if state is not None:
            xpad = torch.cat([state["conv"], xi], dim=1)
        else:
            xpad = F.pad(xi, (0, 0, cw - 1, 0))
        new_conv = xpad[:, xpad.shape[1] - (cw - 1):]
        wconv = self.conv.to(dt_)
        conv = xpad[:, 0:S] * wconv[0]
        for k in range(1, cw):
            conv = conv + xpad[:, k:k + S] * wconv[k]
        xc = F.silu(conv)                                 # [B, S, di]

        bc = torch.einsum("bsi,igz->bsgz", xc, self.wbc.to(dt_))
        bmat, cmat = bc[..., 0, :], bc[..., 1, :]         # [B, S, ds]
        # per-channel step size (softplus-gated, zero-init → dt ≈ ln 2)
        dt = F.softplus(xc * self.wdt.to(dt_) + 1.0)      # [B, S, di]
        amat = -torch.exp(self.alog.float())              # [di, ds]

        h0 = (state["h"] if state is not None
              else torch.zeros((B, di, ds), device=x.device))
        y, h_last = _ssm_scan_chunked(cfg, dt, bmat, cmat, xc, amat, h0)
        y = y.to(dt_) + xc * self.dskip.to(dt_)
        y = y * F.silu(z)
        out = torch.einsum("bsi,id->bsd", y, self.wout.to(dt_))
        new_state = (None if state is None
                     else {"h": h_last, "conv": new_conv})
        return out, new_state


def init_mamba_state(cfg: ModelConfig, B: int,
                     device=None) -> Dict[str, Tensor]:
    di, ds, cw = d_inner_of(cfg), cfg.ssm_state, cfg.ssm_conv
    return {"h": torch.zeros((B, di, ds), device=device),
            "conv": torch.zeros((B, cw - 1, di), dtype=cfg.dtype,
                                device=device)}
