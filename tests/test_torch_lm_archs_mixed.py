"""The MoE, hybrid, vision, xLSTM and encoder-decoder smoke twins through
the port's serving path against the reference's (the checks of
``test_torch_lm_archs.py``), and whisper's clamped positions: decode
past the sinusoidal table and past the cache's end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as rmdl
from test_torch_lm_archs import (check_decode_matches_forward, check_twin,
                                 ref_serve_fns, twin_batch, twin_configs,
                                 twin_weights)
from test_torch_lm_layers import DTYPES, REL_F32, rel

torch.set_num_threads(1)

MIXED = ("qwen3_moe_235b_a22b", "dbrx_132b", "jamba15_large_398b",
         "llama32_vision_90b", "xlstm_125m", "whisper_base")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MIXED)
def test_twin_serves_like_reference(arch, dtype):
    check_twin(arch, dtype)


@pytest.mark.parametrize("arch", MIXED)
def test_twin_decode_matches_full_forward(arch):
    check_decode_matches_forward(arch)


def test_whisper_decode_past_the_table_and_the_cache_like_reference():
    """Whisper's decode reads its sinusoidal rows from a table of
    ``n_audio_tokens + 9`` rows with the start clamped (the smoke
    twin's 24 audio tokens: positions from 33 reuse row 32), and writes
    K/V with the start clamped into the cache (8 slots here): 32 decode
    steps from a 4-token prompt pass both, each equal to the
    reference's."""
    rcfg, pcfg = twin_configs("whisper_base", "f32")
    jp, model = twin_weights(rcfg, pcfg, seed=4)
    rng = np.random.default_rng(5)
    batch = twin_batch(rcfg, rng, 36)
    tokens = batch.pop("tokens")
    batch["tokens"] = tokens[:, :4]
    r_prefill, r_decode = ref_serve_fns(rcfg)
    rl, rstate, rmem = r_prefill(
        jp, {k: jnp.asarray(v) for k, v in batch.items()},
        rmdl.init_serve_state(rcfg, 2, 8))
    pl, pstate, pmem = model.prefill(
        {k: torch.as_tensor(v) for k, v in batch.items()},
        model.init_serve_state(2, 8))
    assert rel(rl, pl) <= REL_F32
    for t in range(4, 36):
        tok = tokens[:, t:t + 1]
        rl, rstate = r_decode(jp, jnp.asarray(tok), rstate, rmem)
        pl, pstate = model.decode_step(torch.as_tensor(tok), pstate, pmem)
        assert rel(rl, pl) <= REL_F32, t
    assert pstate["pos"] == int(rstate["pos"]) == 36
    assert rel(rstate["blk0"]["k"], pstate["blk0"]["k"]) <= REL_F32
    # past the table the last row repeats: positions 33 and 40 read 32's
    with torch.inference_mode():
        tok = torch.as_tensor(tokens[:, :1])
        at = {p: model.embed_tokens(tok, p) for p in (31, 32, 33, 40)}
    assert torch.equal(at[33], at[32]) and torch.equal(at[40], at[32])
    assert not torch.equal(at[32], at[31])
