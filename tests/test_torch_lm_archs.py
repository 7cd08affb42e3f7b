"""The ten LM architectures' smoke twins through the port's serving path
against the reference's, on the CPU, in f32 and in bf16.

Each twin gets the same numpy weights in both packages (every leaf
drawn from numpy, carried into the port by ``interop.lm_params``), the
same prompt and the same teacher-forced tokens: the prefill logits,
``state["pos"]``, every cache and recurrent state after prefill (and
the encoder's memory), then three decode steps' logits and the states
after them, under the bounds of ``test_torch_lm_layers.py``. The port
alone also passes the reference's decode-vs-full-forward check
(``tests/test_archs.py``). This file holds the dense decoders; the MoE,
hybrid, vision, xLSTM and encoder-decoder twins are in
``test_torch_lm_archs_mixed.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import model as rmdl
from repro_torch import interop
from repro_torch.configs import base as pbase
from test_torch_lm_layers import (DTYPES, REL_BF16, REL_BF16_SCAN, REL_F32,
                                  NO_EXCESS, draw_leaves, rel, to_jax)

torch.set_num_threads(1)

B, S, STEPS = 2, 12, 3


def twin_configs(arch: str, dtype: str):
    """(reference smoke config, port smoke config) in ``dtype``."""
    rcfg, pcfg = rbase.get(arch).smoke, pbase.get(arch).smoke
    if dtype == "f32":
        rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
        pcfg = dataclasses.replace(pcfg, dtype=torch.float32)
    return rcfg, pcfg


def twin_bound(cfg, dtype: str) -> float:
    if dtype == "f32":
        return REL_F32
    return REL_BF16_SCAN if cfg.family in ("hybrid", "xlstm") else REL_BF16


def twin_weights(rcfg, pcfg, seed: int):
    """The same numpy weights as (reference params, port model)."""
    shapes, _ = rmdl.abstract_params(rcfg)
    leaves = draw_leaves(shapes, np.random.default_rng(seed))
    return to_jax(leaves), interop.lm_params(pcfg, leaves, device="cpu")


def twin_batch(cfg, rng, S_total: int):
    """Host arrays: tokens [B, S_total] and the modality embeddings."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S_total))}
    if cfg.family == "vision":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.standard_normal(
            (B, cfg.n_audio_tokens, cfg.d_model)).astype(np.float32)
    return batch


def ref_serve_fns(rcfg):
    """The reference's prefill and decode step, compiled as in
    ``test_torch_lm_layers.ref_fn``."""
    prefill = jax.jit(lambda p, b, s: rmdl.prefill(rcfg, p, b, s),
                      compiler_options=NO_EXCESS)
    decode = jax.jit(lambda p, t, s, m: rmdl.decode_step(rcfg, p, t, s, m),
                     compiler_options=NO_EXCESS)
    return prefill, decode


def assert_states_close(rstate, pstate, tol, what):
    assert int(rstate["pos"]) == pstate["pos"], what
    assert set(rstate) == set(pstate), what
    for slot, leaves in rstate.items():
        if slot == "pos":
            continue
        assert set(leaves) == set(pstate[slot]), (what, slot)
        for k, v in leaves.items():
            got = pstate[slot][k]
            assert tuple(got.shape) == v.shape, (what, slot, k)
            assert rel(v, got) <= tol, (what, slot, k, rel(v, got))


def check_twin(arch: str, dtype: str) -> None:
    """Prefill, states and teacher-forced decode of one twin, port
    against reference."""
    rcfg, pcfg = twin_configs(arch, dtype)
    tol = twin_bound(pcfg, dtype)
    jp, model = twin_weights(rcfg, pcfg, seed=0)
    rng = np.random.default_rng(1)
    batch = twin_batch(rcfg, rng, S + STEPS)
    tokens = batch.pop("tokens")
    batch["tokens"] = tokens[:, :S]
    r_prefill, r_decode = ref_serve_fns(rcfg)
    rl, rstate, rmem = r_prefill(
        jp, {k: jnp.asarray(v) for k, v in batch.items()},
        rmdl.init_serve_state(rcfg, B, S + 8))
    pl, pstate, pmem = model.prefill(
        {k: torch.as_tensor(v) for k, v in batch.items()},
        model.init_serve_state(B, S + 8))
    assert pl.shape == (B, pcfg.vocab) and pl.dtype == pcfg.dtype
    assert rel(rl, pl) <= tol, (arch, "prefill", rel(rl, pl))
    assert_states_close(rstate, pstate, tol, (arch, "prefill"))
    assert (rmem is None) == (pmem is None)
    if pmem is not None:
        assert rel(rmem, pmem) <= tol
    for t in range(S, S + STEPS):
        tok = tokens[:, t:t + 1]
        rl, rstate = r_decode(jp, jnp.asarray(tok), rstate, rmem)
        pl, pstate = model.decode_step(torch.as_tensor(tok), pstate, pmem)
        assert rel(rl, pl) <= tol, (arch, "decode", t, rel(rl, pl))
    assert_states_close(rstate, pstate, tol, (arch, "decode"))


def check_decode_matches_forward(arch: str) -> None:
    """The reference's ``test_decode_matches_parallel_forward`` on the
    port: the last position of a full causal forward against prefill on
    the prefix and one decode step (bf16, MoE without dropping)."""
    rcfg, pcfg = twin_configs(arch, "bf16")
    if pcfg.moe_experts:
        # capacity dropping differs between a full forward and decode
        rcfg = dataclasses.replace(rcfg, capacity_factor=float(
            rcfg.moe_experts))
        pcfg = dataclasses.replace(pcfg, capacity_factor=float(
            pcfg.moe_experts))
    _, model = twin_weights(rcfg, pcfg, seed=2)
    batch = {k: torch.as_tensor(v) for k, v in
             twin_batch(pcfg, np.random.default_rng(3), 16).items()}
    full, _ = model(batch)
    state = model.init_serve_state(B, 16 + 4)
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    _, state, mem = model.prefill(pre, state)
    logits, _ = model.decode_step(batch["tokens"][:, -1:], state, mem)
    assert rel(full[:, -1].float().numpy(), logits) < twin_bound(pcfg,
                                                                 "bf16")


DENSE = ("stablelm_1_6b", "stablelm_12b", "yi_34b", "smollm_360m")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_twin_serves_like_reference(arch, dtype):
    check_twin(arch, dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_twin_decode_matches_full_forward(arch):
    check_decode_matches_forward(arch)


def test_every_architecture_is_checked():
    from test_torch_lm_archs_mixed import MIXED
    assert sorted(DENSE + MIXED) == sorted(rbase.lm_arch_ids())
