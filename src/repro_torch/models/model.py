"""Model facade: build, abstract shapes, the training loss, prefill and
cached decode for every architecture family behind one module, `LM`.

Batch conventions:
- train: {"tokens": int [B, S], "labels": int [B, S]} (+ the modality
  embeddings below); a label below 0 is masked out of the loss;
- prefill: {"tokens": int [B, S]} (+ "image_embeds" f32 [B, N_img, d]
  for vision, "audio_embeds" f32 [B, N_aud, d] for encdec) and a
  decode state → (last-token logits, state, cross memory);
- decode: token int [B, 1] + the carried state (+ cross memory) →
  (logits, state).

Modality frontends are stubs: embeddings arrive precomputed.
Parameters are f32; activations are ``cfg.dtype``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decoder as dec
from repro_torch.models import layers as ly
from repro_torch.models.common import (ModelConfig, ParamFactory,
                                       remat_call)
from repro_torch.parallel.logical import constrain

Tensor = torch.Tensor


def _dec_layers(cfg: ModelConfig) -> int:
    return (cfg.n_layers - cfg.enc_layers if cfg.family == "encdec"
            else cfg.n_layers)


class LM(nn.Module):
    """``embed``, ``dec`` (and for encdec ``enc`` + ``enc_ln``),
    ``final_ln``: the reference's top-level parameter groups."""

    def __init__(self, pf: ParamFactory):
        super().__init__()
        cfg = pf.cfg
        self.cfg = cfg
        self.embed = ly.Embeddings(pf)
        if cfg.family == "encdec":
            self.enc = dec.Stack(pf, cfg.enc_layers)
            self.dec = dec.Stack(pf, _dec_layers(cfg), with_cross=True)
            self.enc_ln = ly.Norm(pf, cfg.d_model)
        else:
            self.dec = dec.Stack(pf, cfg.n_layers)
        self.final_ln = ly.Norm(pf, cfg.d_model)
        self._axes = {k: p.logical_axes for k, p in self.named_parameters()}

    def param_axes(self) -> Dict[str, Tuple[str, ...]]:
        """``{parameter name: logical axes}``: the reference's axes of
        the matching leaf without its leading ``"layers"`` (the port
        keeps a parameter a layer). Taken when the model is built, so
        it holds after the parameters are swapped for sharded ones."""
        return dict(self._axes)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    # --------------------------------------------------------- forward

    def embed_tokens(self, tokens: Tensor,
                     pos_offset: Optional[int] = None) -> Tensor:
        """Token embeddings; whisper-style configs (``rope_theta ==
        0``) add the sinusoidal table's rows from ``pos_offset``. The
        table has ``n_audio_tokens + S + 8`` rows and the start is
        clamped so the slice stays inside it, so a decode position past
        the table reuses its last row."""
        cfg = self.cfg
        x = self.embed.embed(tokens)
        if cfg.rope_theta == 0:
            S = tokens.shape[1]
            rows = cfg.n_audio_tokens + S + 8
            pos = ly.sinusoidal_positions(rows, cfg.d_model, x.device)
            start = 0 if pos_offset is None else \
                min(max(int(pos_offset), 0), rows - S)
            x = x + pos[None, start:start + S].to(cfg.dtype)
        return constrain(x, "batch", "seq", "embed")

    def encode(self, audio: Tensor, remat: bool = False) -> Tensor:
        cfg = self.cfg
        pos = ly.sinusoidal_positions(audio.shape[1], cfg.d_model,
                                      audio.device)
        x = audio.to(cfg.dtype) + pos[None].to(cfg.dtype)
        x, _, _ = self.enc.run(x, causal=False, remat=remat)
        return self.enc_ln(x)

    def cross_memory(self, batch: Dict[str, Tensor],
                     remat: bool = False) -> Optional[Tensor]:
        cfg = self.cfg
        if cfg.family == "encdec":
            return self.encode(batch["audio_embeds"], remat)
        if cfg.family == "vision":
            return batch["image_embeds"].to(cfg.dtype)
        return None

    @torch.inference_mode()
    def forward(self, batch: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
        """The full causal forward over ``batch["tokens"]``: (logits
        [B, S, vocab], MoE aux loss)."""
        x = self.embed_tokens(batch["tokens"])
        mem = self.cross_memory(batch)
        x, aux, _ = self.dec.run(x, causal=True, cross_memory=mem)
        x = self.final_ln(x)
        return self.embed.unembed(x), aux

    # --------------------------------------------------------- serving

    def init_serve_state(self, B: int, S_max: int) -> Dict[str, Any]:
        return init_serve_state(self.cfg, B, S_max, self.device)

    @torch.inference_mode()
    def prefill(self, batch: Dict[str, Tensor], state: Dict[str, Any]
                ) -> Tuple[Tensor, Dict[str, Any], Optional[Tensor]]:
        """Consume the prompt and fill the caches (in place); returns
        (last logits [B, vocab], state, cross memory to carry into
        decode)."""
        return self.prefill_body(batch, state)

    def prefill_body(self, batch: Dict[str, Tensor], state: Dict[str, Any]
                     ) -> Tuple[Tensor, Dict[str, Any], Optional[Tensor]]:
        """`prefill` outside inference mode (the sharded serve fns run
        it under ``no_grad``: DTensor re-plans every composite op it
        meets in inference mode)."""
        x = self.embed_tokens(batch["tokens"], pos_offset=state["pos"])
        mem = self.cross_memory(batch)
        x, _, state = self.dec.run(x, causal=True, cross_memory=mem,
                                   decode_state=state)
        x = self.final_ln(x[:, -1:])
        return self.embed.unembed(x)[:, 0], state, mem

    @torch.inference_mode()
    def decode_step(self, token: Tensor, state: Dict[str, Any],
                    cross_memory: Optional[Tensor] = None,
                    ) -> Tuple[Tensor, Dict[str, Any]]:
        """One token for every sequence in the batch. token: int
        [B, 1]."""
        return self.decode_body(token, state, cross_memory)

    def decode_body(self, token: Tensor, state: Dict[str, Any],
                    cross_memory: Optional[Tensor] = None,
                    ) -> Tuple[Tensor, Dict[str, Any]]:
        """`decode_step` outside inference mode."""
        x = self.embed_tokens(token, pos_offset=state["pos"])
        x, _, state = self.dec.run(x, causal=True,
                                   cross_memory=cross_memory,
                                   decode_state=state)
        x = self.final_ln(x)
        return self.embed.unembed(x)[:, 0], state


# ---------------------------------------------------------------- loss

def loss_fn(model: LM, batch: Dict[str, Tensor], *, remat: bool = True,
            aux_weight: float = 0.01) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token cross entropy plus ``aux_weight`` × the MoE balance
    loss, differentiable (not under inference mode, unlike serving).
    Returns ``(loss, {"nll", "aux", "tokens"})``, ``tokens`` the number
    of unmasked labels (f32). ``remat`` recomputes the stack's groups
    in the backward pass (`Stack.run`); the values do not change."""
    cfg = model.cfg
    labels = batch["labels"]
    x = model.embed_tokens(batch["tokens"])
    mem = model.cross_memory(batch, remat)
    x, aux, _ = model.dec.run(x, causal=True, cross_memory=mem,
                              remat=remat)
    x = model.final_ln(x)
    nll = _cross_entropy(model, x, labels)
    loss = nll + aux_weight * aux
    mask = (labels >= 0).float()
    return loss, {"nll": nll, "aux": aux, "tokens": torch.sum(mask)}


def _ce_terms(model: LM, x: Tensor, labels: Tensor) -> Tensor:
    """Σ masked (logsumexp − target logit) over a [B, S', d] slice; the
    logits in f32, the target taken at ``max(label, 0)``."""
    logits = constrain(model.embed.unembed(x), "batch", "seq",
                       "vocab_act").float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp(labels, min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - ll) * mask)


def _cross_entropy(model: LM, x: Tensor, labels: Tensor) -> Tensor:
    """Mean NLL over the unmasked labels (at least 1). With
    ``cfg.loss_chunk = C > 0`` dividing S, and S > C, the sequence is
    taken C positions at a time, each chunk's logits recomputed in the
    backward pass (`torch.utils.checkpoint`), so the [B, S, V] logits
    never exist at once."""
    S = x.shape[1]
    mask_total = torch.clamp(torch.sum((labels >= 0).float()), min=1.0)
    C = model.cfg.loss_chunk
    if C <= 0 or S % C != 0 or S <= C:
        return _ce_terms(model, x, labels) / mask_total
    tot = torch.zeros((), device=x.device)
    for i in range(S // C):
        args = (model, x[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C])
        tot = tot + (remat_call(_ce_terms, "nothing", *args)
                     if torch.is_grad_enabled() else _ce_terms(*args))
    return tot / mask_total


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> LM:
    """An `LM` on ``device`` (default: the card; raises without CUDA)
    with parameters drawn from a ``torch.Generator`` on that device
    seeded with ``seed`` (the values are not ``jax.random``'s)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return LM(ParamFactory(cfg, dev, gen))


#: leaves drawn as 0.1·normal by `randomize_params` (the default init
#: sets the cross gate, ``wdt``, ``alog`` and ``wif`` to zero)
_SMALL_LEAVES = ("bias", "gate", "wdt", "alog", "wif", "dskip")


def randomize_params(model: LM, seed: int) -> LM:
    """Redraws every leaf in place from a CPU ``torch.Generator``
    seeded with ``seed`` (the same values on any device): matrices
    ``normal × 0.02``, norm scales ``1 + 0.1·normal``, biases, gates,
    ``wdt``, ``alog``, ``wif`` and ``dskip`` ``0.1·normal``. No path
    is then multiplied away by a zero init, which checks that compare
    two devices need."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            z = torch.randn(p.shape, generator=gen, dtype=p.dtype)
            z = (1 + 0.1 * z if leaf == "scale" else
                 0.1 * z if leaf in _SMALL_LEAVES else 0.02 * z)
            p.copy_(z)
    return model


def abstract_params(cfg: ModelConfig) -> LM:
    """The model on the ``meta`` device: shapes only, nothing
    allocated."""
    return LM(ParamFactory(cfg, torch.device("meta")))


def init_serve_state(cfg: ModelConfig, B: int, S_max: int,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """The decode state of the decoder stack (KV caches, SSM and xLSTM
    states) on ``device`` (default: the card)."""
    return dec.init_decode_state(cfg, _dec_layers(cfg), B, S_max,
                                 resolve_device(device))
