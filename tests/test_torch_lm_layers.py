"""The LM zoo's shared layers (``repro_torch.models.layers``: norms,
positions, attention by its three routes, caches, MLPs, embeddings)
against the reference's, module by module, on the CPU.

The same numpy inputs and weights go through both packages. Every leaf
is drawn from numpy (matrices ``normal × 0.02``, norm scales
``1 + 0.1·normal``, biases, gates, ``wdt``, ``alog``, ``wif`` and
``dskip`` ``0.1·normal``): the reference's init sets the cross gate,
``wdt``, ``alog`` and ``wif`` to zero, which would multiply those paths
away. The measure is the reference's own (``tests/test_archs.py``):
``rel(a, b) = max|a − b| / max(1, max|a|)``.

The reference is compiled with XLA's ``xla_allow_excess_precision``
off (`ref_fn`), so that each bf16 op rounds as written, as it does op
by op and in the port. With it on (XLA's default) fusion keeps some
bf16 intermediates in f32, and the compiled reference moves away from
its own op-by-op result (by 3e-3 to 8e-3 on the smoke twins' prefill;
by 4e-2 on qwen3's smoke cache, where a routing near-tie flips); with
it off the two agree (bit for bit on qwen3's and jamba's prefill).

Other test files of the LM slice import the helpers below.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rly
from repro.models.common import ModelConfig as RefConfig
from repro.models.common import ParamFactory as RefFactory
from repro_torch.models import layers as ly
from repro_torch.models.common import ModelConfig, ParamFactory

torch.set_num_threads(1)

#: f32 in both packages: every family
REL_F32 = 1e-5
#: bf16 (the configs as shipped): the reference's own bounds
#: (``tests/test_archs.py``), the chunked scans' looser
REL_BF16 = 1e-2
REL_BF16_SCAN = 2e-2

DTYPES = ("f32", "bf16")

#: leaves drawn as 0.1·normal (the reference zero-inits several)
_SMALL = ("bias", "gate", "wdt", "alog", "wif", "dskip")


def rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b.detach().float() if isinstance(b, torch.Tensor) else b,
                   np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(1.0, np.abs(a).max()))


def draw_leaves(shapes, rng):
    """Numpy leaves for a tree of shapes (the reference's
    ``abstract_params``), by leaf name."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = draw_leaves(v, rng)
            continue
        z = rng.standard_normal(v.shape).astype(np.float32)
        out[k] = (1 + 0.1 * z if k == "scale" else
                  0.1 * z if k in _SMALL else 0.02 * z).astype(np.float32)
    return out


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


#: each bf16 op of the reference rounds as written (module docstring)
NO_EXCESS = {"xla_allow_excess_precision": False}


def ref_fn(fn, *static, **static_kw):
    """``fn`` of the reference with its leading (config) and keyword
    arguments bound, compiled with `NO_EXCESS`."""
    return jax.jit(functools.partial(fn, *static, **static_kw),
                   compiler_options=NO_EXCESS)


def configs(dtype: str, **kw):
    """(reference config, port config) with the same fields; ``dtype``
    'f32' or 'bf16'."""
    base = dict(name="t", family="decoder", n_layers=1, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=48, vocab=64)
    base.update(kw)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32" else
              (jnp.bfloat16, torch.bfloat16))
    return RefConfig(**base, dtype=jd), ModelConfig(**base, dtype=td)


def layer(rcfg, pcfg, ref_init, port_cls, rng, **kw):
    """One layer in both packages with the same numpy weights: the
    reference's ``init_*`` (layers=1) gives the shapes, the port's
    module loads the leaves by name."""
    pf = RefFactory(None, rcfg, abstract=True)
    ref_init(pf, "m", 1, **kw)
    leaves = {k: v[0] for k, v in draw_leaves(pf.params["m"], rng).items()}
    mod = port_cls(ParamFactory(pcfg, "cpu", torch.Generator()), **kw)
    mod.load_state_dict({k: torch.as_tensor(v) for k, v in leaves.items()})
    return to_jax(leaves), mod


def activations(rng, shape, dtype: str):
    """The same activation in both packages (rounded to bf16 first
    where the test is in bf16)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        return jx, torch.as_tensor(np.asarray(jx, np.float32)).bfloat16()
    return jnp.asarray(x), torch.as_tensor(x)


def bound(dtype: str, scan: bool = False) -> float:
    return REL_F32 if dtype == "f32" else (REL_BF16_SCAN if scan
                                           else REL_BF16)


# ---------------------------------------------------------------- norms

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_equals_reference(norm, dtype):
    rng = np.random.default_rng(1)
    rcfg, pcfg = configs(dtype, norm=norm)
    pf = RefFactory(None, rcfg, abstract=True)
    rly.init_norm(pf, "n", 32)
    leaves = draw_leaves(pf.params["n"], rng)
    mod = ly.Norm(ParamFactory(pcfg, "cpu"), 32)
    mod.load_state_dict({k: torch.as_tensor(v) for k, v in leaves.items()})
    jx, tx = activations(rng, (2, 5, 32), dtype)
    # an offset mean, where a sample variance would differ
    jx, tx = jx + 3, tx + 3
    want = ref_fn(rly.apply_norm, rcfg)(to_jax(leaves), jx)
    assert rel(want, mod(tx)) <= bound(dtype)


# ---------------------------------------------------------- positions

@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_is_rotate_half_like_reference(dtype):
    rng = np.random.default_rng(2)
    jx, tx = activations(rng, (2, 9, 3, 16), dtype)
    pos = np.arange(9)[None, :] + np.array([[0], [7]])
    want = ref_fn(rly.rope, theta=10_000.0)(jx, jnp.asarray(pos))
    got = ly.rope(tx, torch.as_tensor(pos), 10_000.0)
    assert got.dtype == tx.dtype
    assert rel(want, got) <= bound(dtype)
    # interleaved pairs would rotate a different pair of lanes
    assert rel(want, got.reshape(2, 9, 3, 8, 2).flip(-1).reshape(
        2, 9, 3, 16)) > 1e-2


def test_sinusoidal_table_is_sin_then_cos_like_reference():
    want = rly.sinusoidal_positions(40, 64)
    got = ly.sinusoidal_positions(40, 64)
    assert rel(want, got) <= REL_F32
    assert np.allclose(np.asarray(got[:, :32]),
                       np.sin(np.arange(40)[:, None]
                              * 10_000.0 ** (-np.arange(32) / 32)),
                       atol=1e-5)


# ------------------------------------------------------------ attention

ROUTES = {"repeat_kv": {}, "gqa_grouped": {"gqa_grouped": True},
          "attn_chunk": {"attn_chunk": 7}}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_attention_routes_prefill_and_cached_decode(route, dtype):
    """Causal prefill without a cache (S = 12: the 7-wide chunks pad
    the KV by 2), then prefill into a cache of 20 (pads by 1) and three
    decode steps; outputs and caches equal the reference's."""
    rng = np.random.default_rng(3)
    rcfg, pcfg = configs(dtype, **ROUTES[route])
    p, mod = layer(rcfg, pcfg, rly.init_attention, ly.Attention, rng)
    jx, tx = activations(rng, (2, 12, 32), dtype)
    attn = ref_fn(rly.attention, rcfg)
    with torch.inference_mode():
        want, _ = attn(p, jx)
        got, none = mod(tx)
        assert none is None
        assert rel(want, got) <= bound(dtype)
        rc = rly.init_cache(rcfg, 2, 20)
        pc = ly.init_cache(pcfg, 2, 20)
        want, rc = attn(p, jx[:, :9], cache=rc)
        got, pc = mod(tx[:, :9], cache=pc)
        assert rel(want, got) <= bound(dtype)
        for t in range(9, 12):
            want, rc = attn(p, jx[:, t:t + 1], cache=rc)
            got, pc = mod(tx[:, t:t + 1], cache=pc)
            assert rel(want, got) <= bound(dtype)
        assert int(rc["pos"]) == pc["pos"] == 12
        for k in ("k", "v"):
            assert rel(rc[k], pc[k]) <= bound(dtype)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_attention_cache_write_clamps_like_reference(route):
    """Decode past the cache's end: the write's start is clamped so the
    slice stays inside (the last slot is overwritten), positions keep
    counting."""
    rng = np.random.default_rng(4)
    rcfg, pcfg = configs("f32", **ROUTES[route])
    p, mod = layer(rcfg, pcfg, rly.init_attention, ly.Attention, rng)
    jx, tx = activations(rng, (2, 10, 32), "f32")
    rc, pc = rly.init_cache(rcfg, 2, 8), ly.init_cache(pcfg, 2, 8)
    attn = ref_fn(rly.attention, rcfg)
    with torch.inference_mode():
        want, rc = attn(p, jx[:, :6], cache=rc)
        got, pc = mod(tx[:, :6], cache=pc)
        for t in range(6, 10):
            want, rc = attn(p, jx[:, t:t + 1], cache=rc)
            got, pc = mod(tx[:, t:t + 1], cache=pc)
            assert rel(want, got) <= REL_F32
    assert int(rc["pos"]) == pc["pos"] == 10
    for k in ("k", "v"):
        assert rel(rc[k], pc[k]) <= REL_F32


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_with_gate_and_untouched_cache(dtype):
    """Gated cross attention over a memory (no rope, no mask), with a
    non-zero gate; with a cache, the cache comes back untouched."""
    rng = np.random.default_rng(5)
    rcfg, pcfg = configs(dtype)
    p, mod = layer(rcfg, pcfg, rly.init_attention, ly.Attention, rng,
                   cross=True)
    assert abs(float(p["gate"])) > 0
    jx, tx = activations(rng, (2, 5, 32), dtype)
    jm, tm = activations(rng, (2, 11, 32), dtype)
    attn = ref_fn(rly.attention, rcfg)
    with torch.inference_mode():
        want, _ = attn(p, jx, kv_src=jm)
        got, _ = mod(tx, kv_src=tm)
        assert rel(want, got) <= bound(dtype)
        pc = ly.init_cache(pcfg, 2, 8)
        pc["k"].normal_()
        before = pc["k"].clone()
        want, _ = attn(p, jx[:, :1], kv_src=jm,
                       cache=rly.init_cache(rcfg, 2, 8))
        got, out = mod(tx[:, :1], kv_src=tm, cache=pc)
        assert rel(want, got) <= bound(dtype)
    assert out is pc and torch.equal(pc["k"], before)


# ----------------------------------------------------------------- MLP

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_equals_reference(act, dtype):
    rng = np.random.default_rng(6)
    rcfg, pcfg = configs(dtype, act=act)
    p, mod = layer(rcfg, pcfg, rly.init_mlp, ly.MLP, rng)
    # large activations: gelu's tanh form differs from the erf form
    jx, tx = activations(rng, (2, 7, 32), dtype)
    want = ref_fn(rly.mlp, rcfg)(p, jx * 30)
    with torch.inference_mode():
        got = mod(tx * 30)
    assert rel(want, got) <= bound(dtype)


def test_embeddings_equal_reference():
    rng = np.random.default_rng(7)
    for dtype in DTYPES:
        rcfg, pcfg = configs(dtype)
        pf = RefFactory(None, rcfg, abstract=True)
        rly.init_embeddings(pf)
        leaves = draw_leaves(pf.params["embed"], rng)
        mod = ly.Embeddings(ParamFactory(pcfg, "cpu"))
        mod.load_state_dict({k: torch.as_tensor(v)
                             for k, v in leaves.items()})
        tokens = rng.integers(0, 64, (2, 5))
        x = ref_fn(rly.embed, rcfg)(to_jax(leaves), jnp.asarray(tokens))
        with torch.inference_mode():
            got = mod.embed(torch.as_tensor(tokens))
            assert got.dtype == pcfg.dtype and rel(x, got) == 0
            assert rel(ref_fn(rly.unembed, rcfg)(to_jax(leaves), x),
                       mod.unembed(got)) <= bound(dtype)
