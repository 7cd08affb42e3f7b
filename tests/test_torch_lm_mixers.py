"""The LM zoo's mixers and expert FFN (``repro_torch.models.moe``,
``mamba``, ``xlstm``) against the reference's, module by module, on
the CPU: MoE with dropped tokens and a built top-k tie, Mamba over a
padded chunk tail and its decode state, mLSTM at S = 15 over chunks of
8 and its decode, sLSTM. Inputs, weights, bounds and the reference's
evaluation as in ``test_torch_lm_layers.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as rmb
from repro.models import moe as rmoe
from repro.models import xlstm as rxl
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from test_torch_lm_layers import (DTYPES, REL_F32, activations, bound,
                                  configs, layer, ref_fn, rel)

torch.set_num_threads(1)


# ----------------------------------------------------------------- MoE

def test_top_k_puts_the_lower_index_first_on_ties():
    rng = np.random.default_rng(8)
    probs = rng.integers(0, 4, (64, 9)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 4)
    got_v, got_i = moe_mod.top_k(torch.as_tensor(probs), 4)
    assert np.array_equal(np.asarray(want_i), got_i.numpy())
    assert np.array_equal(np.asarray(want_v), got_v.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_drops_tokens_and_breaks_a_built_tie_like_reference(
        act, dtype, monkeypatch):
    """Two routing groups (the group size cut to 16); every token goes
    to expert 0 first, past its capacity, and experts 1 and 2 tie
    exactly for the second choice (equal router columns), which must
    go to the lower index: output and aux loss equal the reference's."""
    monkeypatch.setattr(rmoe, "MOE_GROUP", 16)
    monkeypatch.setattr(moe_mod, "MOE_GROUP", 16)
    rng = np.random.default_rng(9)
    rcfg, pcfg = configs(dtype, act=act, moe_experts=4, moe_topk=2,
                         capacity_factor=1.0)
    p, mod = layer(rcfg, pcfg, rmoe.init_moe, moe_mod.MoE, rng)
    router = np.asarray(p["router"]).copy()
    router[:, 0] = 0.2                   # the inputs' mean is 1
    router[:, 2] = router[:, 1]
    router[:, 3] = -0.05
    p = dict(p, router=jnp.asarray(router))
    mod.router.data = torch.as_tensor(router)
    jx, tx = activations(rng, (2, 16, 32), dtype)
    jx, tx = jx + 1, tx + 1
    want, want_aux = ref_fn(rmoe.moe_ffn, rcfg)(p, jx)
    with torch.inference_mode():
        got, got_aux = mod(tx)
        logits = torch.einsum("gsd,de->gse", tx.reshape(2, 16, 32),
                              mod.router.to(pcfg.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    _, gate_i = moe_mod.top_k(probs, 2)
    assert torch.equal(probs[..., 1], probs[..., 2])
    assert bool((gate_i[..., 0] == 0).all())
    assert bool((gate_i[..., 1] == 1).all())
    C = moe_mod.group_capacity(pcfg, 16)
    assert C == rmoe.group_capacity(rcfg, 16) < 16       # drops happen
    assert rel(want, got) <= bound(dtype)
    assert abs(float(want_aux) - float(got_aux)) <= 1e-5


def test_group_capacity_equals_reference():
    for E, K, cf in ((8, 2, 1.25), (16, 4, 1.0), (128, 8, 1.25),
                     (4, 2, 4.0), (16, 2, 0.3)):
        rcfg, pcfg = configs("f32", moe_experts=E, moe_topk=K,
                             capacity_factor=cf)
        for g in (1, 2, 7, 32, 1000, 1024):
            assert (moe_mod.group_capacity(pcfg, g)
                    == rmoe.group_capacity(rcfg, g))


# ---------------------------------------------------------------- Mamba

@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_prefill_state_and_decode_like_reference(dtype):
    """S = 13 over chunks of 4 (a padded tail); the same prompt with a
    state, then three decode steps carrying h and the conv tail."""
    rng = np.random.default_rng(10)
    rcfg, pcfg = configs(dtype, family="hybrid", ssm_chunk=4,
                         d_model=16, ssm_state=8)
    p, mod = layer(rcfg, pcfg, rmb.init_mamba, mb.Mamba, rng)
    jx, tx = activations(rng, (2, 16, 16), dtype)
    tol = bound(dtype, scan=True)
    block = ref_fn(rmb.mamba_block, rcfg)
    with torch.inference_mode():
        want, _ = block(p, jx[:, :13])
        got, none = mod(tx[:, :13])
        assert none is None and rel(want, got) <= tol
        rs = rmb.init_mamba_state(rcfg, 2)
        ps = mb.init_mamba_state(pcfg, 2)
        want, rs = block(p, jx[:, :13], state=rs)
        got, ps = mod(tx[:, :13], state=ps)
        assert rel(want, got) <= tol
        for t in range(13, 16):
            want, rs = block(p, jx[:, t:t + 1], state=rs)
            got, ps = mod(tx[:, t:t + 1], state=ps)
            assert rel(want, got) <= tol
    for k in ("h", "conv"):
        assert rel(rs[k], ps[k]) <= tol


def test_mamba_scan_is_exact_in_real_arithmetic():
    """The doubling scan equals a step-by-step recurrence in f64."""
    rng = np.random.default_rng(11)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, 11, 3, 4)))
    b = torch.as_tensor(rng.standard_normal((2, 11, 3, 4)))
    aa, bb = mb._scan_chunk(a, b)
    h, prod = torch.zeros(2, 3, 4, dtype=a.dtype), torch.ones_like(a[:, 0])
    for t in range(11):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        assert torch.allclose(bb[:, t], h, rtol=1e-12, atol=1e-12)
        assert torch.allclose(aa[:, t], prod, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- xLSTM

@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_chunks_and_decode_like_reference(dtype):
    """S = 15 over chunks of 8 (the second padded with logi = -1e30),
    then three decode steps from the carried (C, n, m)."""
    rng = np.random.default_rng(12)
    rcfg, pcfg = configs(dtype, family="xlstm", ssm_chunk=8, n_kv_heads=4,
                         d_ff=0)
    p, mod = layer(rcfg, pcfg, rxl.init_mlstm, xl.MLSTM, rng)
    jx, tx = activations(rng, (2, 18, 32), dtype)
    tol = bound(dtype, scan=True)
    block = ref_fn(rxl.mlstm_block, rcfg)
    with torch.inference_mode():
        want, _ = block(p, jx[:, :15])
        got, _ = mod(tx[:, :15])
        assert rel(want, got) <= tol
        rs = rxl.init_mlstm_state(rcfg, 2)
        ps = xl.init_mlstm_state(pcfg, 2)
        want, rs = block(p, jx[:, :15], state=rs)
        got, ps = mod(tx[:, :15], state=ps)
        assert rel(want, got) <= tol
        for t in range(15, 18):
            want, rs = block(p, jx[:, t:t + 1], state=rs)
            got, ps = mod(tx[:, t:t + 1], state=ps)
            assert rel(want, got) <= tol
    for k in ("C", "n", "m"):
        assert rel(rs[k], ps[k]) <= tol


def test_mlstm_depends_on_the_chunk_cut():
    """Why the port cuts chunks where the reference does: the same
    block cut at 4 instead of 8 lands far outside the f32 bound (the
    normaliser clamp acts on stabilised quantities)."""
    rng = np.random.default_rng(13)
    rcfg, pcfg = configs("f32", family="xlstm", ssm_chunk=8, n_kv_heads=4,
                         d_ff=0)
    p, mod = layer(rcfg, pcfg, rxl.init_mlstm, xl.MLSTM, rng)
    jx, tx = activations(rng, (2, 15, 32), "f32")
    jx, tx = 20 * jx, 20 * tx
    want, _ = ref_fn(rxl.mlstm_block, rcfg)(p, jx)
    with torch.inference_mode():
        assert rel(want, mod(tx)[0]) <= REL_F32
        mod.cfg = dataclasses.replace(pcfg, ssm_chunk=4)
        assert rel(want, mod(tx)[0]) > 100 * REL_F32


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_sequence_and_decode_like_reference(dtype):
    rng = np.random.default_rng(14)
    rcfg, pcfg = configs(dtype, family="xlstm", n_kv_heads=4, d_ff=0)
    p, mod = layer(rcfg, pcfg, rxl.init_slstm, xl.SLSTM, rng)
    jx, tx = activations(rng, (2, 9, 32), dtype)
    tol = bound(dtype, scan=True)
    block = ref_fn(rxl.slstm_block, rcfg)
    with torch.inference_mode():
        want, _ = block(p, jx[:, :7])
        got, _ = mod(tx[:, :7])
        assert rel(want, got) <= tol
        rs = rxl.init_slstm_state(rcfg, 2)
        ps = xl.init_slstm_state(pcfg, 2)
        for sl in (slice(0, 7), slice(7, 8), slice(8, 9)):
            want, rs = block(p, jx[:, sl], state=rs)
            got, ps = mod(tx[:, sl], state=ps)
            assert rel(want, got) <= tol
    for k in ("c", "n", "h"):
        assert rel(rs[k], ps[k]) <= tol
