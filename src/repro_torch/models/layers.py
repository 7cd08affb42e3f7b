"""Shared neural layers: norms, RoPE, GQA attention (prefill and
cached decode), dense MLPs, embeddings.

One ``nn.Module`` per sub-layer kind; each parameter carries the
reference's leaf name and per-layer shape (``wq [d, H, hd]``,
``wi [d, 2|1, f]``), so a reference layer's leaves load by name.

Dtypes follow the reference's promotion rules site by site: where it
multiplies a ``cfg.dtype`` activation by an f32 weight (attention's
q/k/v and ``wo``, the MLP) the product is taken in f32 and cast back;
where it casts the weight first (``unembed``) the product is in
``cfg.dtype``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (ModelConfig, ParamFactory,
                                       einsum_batched)

Tensor = torch.Tensor


# ---------------------------------------------------------------- norms

class Norm(nn.Module):
    """RMSNorm or LayerNorm (``cfg.norm``), computed in f32, eps 1e-6;
    LayerNorm's variance is the population variance."""

    def __init__(self, pf: ParamFactory, d: int):
        super().__init__()
        self.kind = pf.cfg.norm
        self.scale = pf.add((d,), ("norm_d",), init="ones")
        if self.kind == "layernorm":
            self.bias = pf.add((d,), ("norm_d",), init="zeros")

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            var = torch.mean(xf * xf, dim=-1, keepdim=True)
            out = xf * torch.rsqrt(var + 1e-6) * self.scale
        else:
            mu = torch.mean(xf, dim=-1, keepdim=True)
            var = torch.var(xf, dim=-1, keepdim=True, correction=0)
            out = (xf - mu) * torch.rsqrt(var + 1e-6) * self.scale \
                + self.bias
        return out.to(x.dtype)


# ---------------------------------------------------------------- RoPE

@functools.lru_cache(maxsize=64)
def _inv_freqs(half: int, theta: float, device) -> Tensor:
    """``theta ** (-arange(half) / half)`` in f32, computed on the CPU
    so every device rotates by the same frequencies, and copied to
    ``device`` once (a copy on every call would wait for the card).
    Made outside inference mode even when serving asks first, so that a
    later training step of the same process may use it."""
    with torch.inference_mode(False):
        ar = torch.arange(0, half, dtype=torch.float32)
        return torch.pow(torch.tensor(theta, dtype=torch.float32),
                         -ar / half).to(device)


def _f32_sqrt(n: int) -> float:
    """``sqrt(f32(n))`` rounded to f32, as a host scalar (the
    reference's ``jnp.sqrt(jnp.float32(n))``)."""
    return float(np.sqrt(np.float32(n)))


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotate-half RoPE (the first half of ``hd`` against the second).
    x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    half = x.shape[-1] // 2
    freqs = _inv_freqs(half, float(theta), x.device)
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(S: int, d: int, device=None) -> Tensor:
    """[S, d] f32: ``[sin | cos]`` of ``pos * 10000 ** (-i / half)``."""
    half = d // 2
    freqs = _inv_freqs(half, 10_000.0, torch.device(device or "cpu"))
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------ attention

def init_cache(cfg: ModelConfig, B: int, S_max: int,
               device=None) -> Dict[str, object]:
    """{"k", "v": [B, S_max, KV, hd] in ``cfg.dtype``, "pos": 0}."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((B, S_max, KV, hd), dtype=cfg.dtype,
                             device=device),
            "v": torch.zeros((B, S_max, KV, hd), dtype=cfg.dtype,
                             device=device),
            "pos": 0}


def write_clamped(buf: Tensor, new: Tensor, start: int, dim: int) -> None:
    """``buf[start:start+S] = new`` along ``dim``, in place, with the
    start clamped into ``[0, len - S]`` so the slice stays inside
    ``buf`` (``lax.dynamic_update_slice_in_dim``'s rule)."""
    S = new.shape[dim]
    if S == buf.shape[dim]:
        # a whole-buffer write: a DTensor cannot narrow a dimension it
        # shards
        buf.copy_(new)
        return
    start = min(max(int(start), 0), buf.shape[dim] - S)
    buf.narrow(dim, start, S).copy_(new)


def _chunked_attention(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                       q_pos: Tensor, kv_valid: Tensor) -> Tensor:
    """Online softmax over KV chunks of ``cfg.attn_chunk``: the
    [S, T] score matrix never materialises, the peak is
    [B, S, H, chunk]. q: [B,S,H,hd]; k/v: [B,T,KV,hd]; q_pos: [B,S]
    absolute positions; kv_valid: [T] bool."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    C = min(cfg.attn_chunk, T)
    pad = (-T) % C
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid = F.pad(kv_valid, (0, pad))
    NC = (T + pad) // C
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    scale = float(np.float32(1.0) / np.float32(_f32_sqrt(hd)))
    m = torch.full((B, S, KV, G), -torch.inf, device=q.device)
    ls = torch.zeros((B, S, KV, G), device=q.device)
    acc = torch.zeros((B, S, KV, G, hd), device=q.device)
    for idx in range(NC):
        kc = k[:, idx * C:(idx + 1) * C]
        vc = v[:, idx * C:(idx + 1) * C]
        validc = kv_valid[idx * C:(idx + 1) * C]
        kv_pos = idx * C + torch.arange(C, device=q.device)
        s = einsum_batched("bskgh,btkh->bskgt", qg, kc).float() * scale
        mask = (q_pos[:, :, None] >= kv_pos[None, None, :]) \
            & validc[None, None, :]
        s = torch.where(mask[:, :, None, None, :], s, -torch.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        ls = ls * corr + torch.sum(p, dim=-1)
        pv = einsum_batched("bskgt,btkh->bskgh", p.to(cfg.dtype),
                          vc).float()
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(ls, min=1e-30)[..., None]
    return out.reshape(B, S, H, hd).to(cfg.dtype)


def _mask_scores(scores: Tensor, cache, kv_src, causal: bool,
                 pos_q: Tensor, S: int, T: int, grouped: bool) -> Tensor:
    """Decode-validity and causal masks. scores: [B,H,S,T] or grouped
    [B,KV,G,S,T]."""
    def expand(m):          # [B,S,T] or [S,T] → the scores' rank
        if m.dim() == 2:
            m = m[None]
        return m[:, None, None] if grouped else m[:, None]

    ar = torch.arange(T, device=scores.device)
    if cache is not None and kv_src is None:
        valid = ar[None, :] < cache["pos"]
        causal_m = pos_q[:, :, None] >= ar[None, None, :]
        mask = valid[:, None, :] & causal_m
        return torch.where(expand(mask), scores, -torch.inf)
    if causal and kv_src is None:
        causal_m = torch.tril(torch.ones((S, T), dtype=torch.bool,
                                         device=scores.device))
        return torch.where(expand(causal_m), scores, -torch.inf)
    return scores


class Attention(nn.Module):
    """GQA attention, self or cross (``kv_src``), with an optional
    tanh gate (a vision cross-attention layer's)."""

    def __init__(self, pf: ParamFactory, cross: bool = False):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = pf.add((d, H, hd), ("d_model", "q_heads", "head_dim"))
        self.wk = pf.add((d, KV, hd), ("d_model", "kv_heads", "head_dim"))
        self.wv = pf.add((d, KV, hd), ("d_model", "kv_heads", "head_dim"))
        self.wo = pf.add((H, hd, d), ("q_heads", "head_dim", "d_model"))
        if cross:
            self.gate = pf.add((), (), init="zeros")   # tanh-gated x-attn

    def forward(self, x: Tensor, *, kv_src: Optional[Tensor] = None,
                causal: bool = True, use_rope: bool = True,
                cache: Optional[Dict[str, object]] = None,
                ) -> Tuple[Tensor, Optional[Dict[str, object]]]:
        """x: [B, S, d]. ``kv_src``: the cross-attention source (image
        or audio memory). ``cache``: {"k", "v": [B, S_max, KV, hd],
        "pos": int} for incremental decode; the new K/V are written
        into it in place at ``[pos, pos + S)`` (start clamped into the
        cache) and the returned cache carries ``pos + S``. A cross
        layer's cache is returned untouched. Returns (out [B, S, d],
        cache)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        src = x if kv_src is None else kv_src
        # activation × f32 weight: the product is f32, then cast
        q = torch.einsum("bsd,dhk->bshk", x.float(), self.wq).to(cfg.dtype)
        k = torch.einsum("bsd,dhk->bshk", src.float(),
                         self.wk).to(cfg.dtype)
        v = torch.einsum("bsd,dhk->bshk", src.float(),
                         self.wv).to(cfg.dtype)

        pos_q = torch.arange(S, device=x.device)[None, :]
        if cache is not None:
            pos_q = pos_q + cache["pos"]
        if use_rope and kv_src is None:
            q = rope(q, pos_q, cfg.rope_theta)
            k = rope(k, pos_q, cfg.rope_theta)

        if cache is not None and kv_src is None:
            write_clamped(cache["k"], k, cache["pos"], 1)
            write_clamped(cache["v"], v, cache["pos"], 1)
            cache = dict(cache, pos=cache["pos"] + S)
            k, v = cache["k"], cache["v"]

        T = k.shape[1]
        if cfg.attn_chunk > 0 and kv_src is None and causal:
            ar = torch.arange(T, device=x.device)
            if cache is not None:
                kv_valid = ar < cache["pos"]
                q_pos = pos_q.expand(B, S)
            else:
                kv_valid = torch.ones((T,), dtype=torch.bool,
                                      device=x.device)
                q_pos = torch.arange(S, device=x.device)[None].expand(B, S)
            out = _chunked_attention(cfg, q, k, v, q_pos, kv_valid)
        else:
            grouped = cfg.gqa_grouped and H != KV
            if grouped:
                # grouped einsum: no KV head replication
                qg = q.reshape(B, S, KV, H // KV, hd)
                scores = einsum_batched("bskgh,btkh->bkgst", qg, k)
            else:
                # jnp.repeat(k, g, axis=2): each KV head repeated in place
                if H != KV:
                    k = k.repeat_interleave(H // KV, dim=2)
                    v = v.repeat_interleave(H // KV, dim=2)
                scores = einsum_batched("bshk,bthk->bhst", q, k)
            scores = _mask_scores(scores.float() / _f32_sqrt(hd), cache,
                                  kv_src, causal, pos_q, S, T, grouped)
            w = torch.softmax(scores, dim=-1).to(cfg.dtype)
            if grouped:
                out = einsum_batched("bkgst,btkh->bskgh", w, v).reshape(
                    B, S, H, hd)
            else:
                out = einsum_batched("bhst,bthk->bshk", w, v)
        out = torch.einsum("bshk,hkd->bsd", out.float(), self.wo)
        if hasattr(self, "gate"):
            out = out * torch.tanh(self.gate).to(cfg.dtype).float()
        return out.to(cfg.dtype), cache


# ----------------------------------------------------------------- MLP

class MLP(nn.Module):
    """SwiGLU (``wi [d, 2, f]``) or tanh-approximated GELU
    (``wi [d, 1, f]``)."""

    def __init__(self, pf: ParamFactory):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        g = 2 if cfg.act == "swiglu" else 1
        self.wi = pf.add((cfg.d_model, g, cfg.d_ff),
                         ("d_model", "gate2", "ff"))
        self.wo = pf.add((cfg.d_ff, cfg.d_model), ("ff", "d_model"))

    def forward(self, x: Tensor) -> Tensor:
        cfg = self.cfg
        h = torch.einsum("bsd,dgf->bsgf", x.float(), self.wi).to(cfg.dtype)
        if cfg.act == "swiglu":
            h = F.silu(h[..., 0, :]) * h[..., 1, :]
        else:
            h = F.gelu(h[..., 0, :], approximate="tanh")
        return torch.einsum("bsf,fd->bsd", h.float(), self.wo).to(cfg.dtype)


# ----------------------------------------------------------- embeddings

class Embeddings(nn.Module):
    """Token table ``tok [vocab, d]`` and, untied, ``out [d, vocab]``."""

    def __init__(self, pf: ParamFactory):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        self.tok = pf.add((cfg.vocab, cfg.d_model), ("vocab", "embed_d"))
        if not cfg.tie_embeddings:
            self.out = pf.add((cfg.d_model, cfg.vocab),
                              ("embed_d", "vocab"))

    def embed(self, tokens: Tensor) -> Tensor:
        return F.embedding(tokens, self.tok).to(self.cfg.dtype)

    def unembed(self, x: Tensor) -> Tensor:
        """Logits in ``cfg.dtype``: the weight is cast first."""
        w = self.tok.T if self.cfg.tie_embeddings else self.out
        return torch.matmul(x, w.to(self.cfg.dtype))
