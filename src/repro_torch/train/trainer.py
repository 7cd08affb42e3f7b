"""Step factories for the LM zoo. This slice ports the serving one,
`make_serve_fns`; the training steps come next."""

from __future__ import annotations

from repro_torch.models.common import ModelConfig


def make_serve_fns(cfg: ModelConfig):
    """Returns ``(prefill_fn, decode_fn)``:

    - ``prefill_fn(params, batch, state) -> (logits, state, memory)``;
    - ``decode_fn(params, token, state, cross_memory=None) -> (logits,
      state)``;

    where ``params`` is the `repro_torch.models.LM` built for ``cfg``.
    The reference's factory also takes a device mesh and logical
    sharding rules; one card has no mesh, so this one takes neither.
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
