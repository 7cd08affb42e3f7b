"""The LM zoo's training path in the port against the reference's, on
the CPU: the loss, its gradients, remat, the chunked loss, the train
step (three steps, and with gradient accumulation), the eval step and
the bf16 loss, one case per smoke twin (this file the dense decoders,
``test_torch_lm_train_mixed.py`` the rest).

Each twin gets the same numpy weights in both packages (every leaf
drawn, as in ``test_torch_lm_layers.py``), carried into the port's
training state by ``interop.train_state``; batches of B = 4 sequences
of S = 16 with three labels masked (−1). In f32:

- ``loss_fn``'s loss, nll, aux and tokens within rel `REL_F32` of the
  reference's ``loss_fn(remat=False)``;
- every parameter's gradient within `GRAD_REL` of ``jax.grad``'s
  (``‖g_port − g_ref‖ / ‖g_ref‖`` a leaf; the port's per-group leaves
  stacked back by ``interop.lm_tree``; measured ≤ 2e-6);
- the port with remat equals it without, bit for bit, under each
  ``remat_policy`` (``dots``, ``nothing``, ``sublayer``);
- ``dots`` keeps as many products as the reference's
  ``dots_with_no_batch_dims_saveable`` (its ``dot_general``s without
  batch dims inside ``jax.checkpoint``, times the scans' lengths) and
  recomputes the rest;
- ``loss_chunk = 8`` (two chunks) against the reference's chunked loss
  (`REL_F32`), its gradients against the port's unchunked ones
  (`GRAD_REL`);
- three ``make_train_step`` steps against the reference's jitted step
  (remat on): the losses within `REL_F32`, the final params and
  moments a leaf within `PARAM_REL` (relative norm),
  ``opt.step == 3``;
- ``accum_steps = 2`` against the reference's accumulation branch (its
  metrics: ``aux`` 0, ``tokens`` the batch's size);
- ``make_eval_step``: the loss without autograd, equal to
  ``loss_fn(remat=False)``.

In bf16 (the configs as shipped) the first train step's loss is within
the reference's bounds (1e-2; 2e-2 for the hybrid and xLSTM), the
reference compiled with ``xla_allow_excess_precision`` off. Serving a
model, then training it, in one process gives the gradients of
training alone.
"""

import collections
import dataclasses

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_smoke_mesh
from repro.models import model as rmdl
from repro.optim import adamw as radamw
from repro.parallel.sharding import TP_RULES
from repro.train import trainer as rtrainer
from repro_torch import interop
from repro_torch.models import common
from repro_torch.models import layers as ly
from repro_torch.models import model as mdl
from repro_torch.optim import adamw
from repro_torch.train import trainer
from test_torch_lm_archs import DENSE, twin_bound, twin_configs
from test_torch_lm_layers import REL_F32, draw_leaves, ref_fn, rel

torch.set_num_threads(1)

B, S, CHUNK, STEPS = 4, 16, 8, 3
#: relative norm of a gradient's difference, a leaf
GRAD_REL = 1e-5
#: params and moments after the train steps: ‖Δ‖ / ‖leaf‖ (Adam's
#: ``m / sqrt(v)`` magnifies the relative error of a small gradient
#: element, so an element's own difference is not bounded by it)
PARAM_REL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
POLICIES = ("dots", "nothing", "sublayer")


def train_batch(cfg, seed: int):
    """Host arrays: tokens and labels [B, S] (three labels −1), the
    family's modality embeddings."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :2] = -1
    labels[B - 1, S - 1] = -1
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": labels}
    if cfg.family == "vision":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.standard_normal(
            (B, cfg.n_audio_tokens, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def leaves_of(tree, prefix=""):
    """``(path, f32 numpy leaf)`` of a nested dict; tensors (the port's,
    bf16 too) go to the host as their exact f32."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_of(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v.detach().float().cpu().numpy()
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def assert_trees_close(want, got, measure, tol, what):
    """Every leaf of two reference-layout trees within ``tol``."""
    got = dict(leaves_of(got))
    want = dict(leaves_of(want))
    assert want.keys() == got.keys(), what
    for k, a in want.items():
        assert a.shape == got[k].shape, (what, k)
        err = measure(a, got[k])
        assert err <= tol, (what, k, err)


def norm_rel(a, b) -> float:
    den = np.linalg.norm(a)
    return float(np.linalg.norm(a - b) / den) if den else \
        float(np.abs(b).max())


def max_rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def ref_state(rcfg, rocfg, seed: int):
    shapes, _ = rmdl.abstract_params(rcfg)
    params = draw_leaves(shapes, np.random.default_rng(seed))
    return jax.tree.map(np.asarray, rtrainer.TrainState(
        params=params, opt=radamw.init(rocfg, params)))


def opt_configs(**kw):
    return (radamw.AdamWConfig(**OPT, **kw), adamw.AdamWConfig(**OPT, **kw))


def check_loss_and_grads(arch: str) -> None:
    """Loss, metrics and gradients against ``jax.grad``; remat on equals
    off under every policy; the chunked loss."""
    rcfg, pcfg = twin_configs(arch, "f32")
    rocfg, pocfg = opt_configs()
    st = ref_state(rcfg, rocfg, seed=0)
    batch = train_batch(rcfg, seed=1)
    (rloss, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, b: rmdl.loss_fn(rcfg, p, b, remat=False),
        has_aux=True))(st.params, jax_batch(batch))
    model = interop.train_state(pcfg, pocfg, st, "cpu").params
    tb = torch_batch(batch)
    loss, m, g = trainer.loss_and_grads(model, tb, remat=False)
    assert set(m) == set(rm) == {"nll", "aux", "tokens"}
    assert rel(rloss, loss.detach()) <= REL_F32, (arch, "loss")
    for k in m:
        assert m[k].dtype == torch.float32
        assert rel(rm[k], m[k].detach()) <= REL_F32, (arch, k)
    assert float(m["tokens"]) == B * S - 3
    assert_trees_close(rg, interop.lm_tree(g), norm_rel,
                       GRAD_REL, (arch, "grads"))

    for policy in POLICIES:
        model.cfg = dataclasses.replace(pcfg, remat_policy=policy)
        for stack in (model.dec, getattr(model, "enc", None)):
            if stack is not None:
                stack.cfg = model.cfg
        loss_r, _, g_r = trainer.loss_and_grads(model, tb, remat=True)
        assert torch.equal(loss_r, loss), (arch, policy)
        for k in g:
            assert torch.equal(g_r[k], g[k]), (arch, policy, k)

    rchunk = dataclasses.replace(rcfg, loss_chunk=CHUNK)
    pchunk = dataclasses.replace(pcfg, loss_chunk=CHUNK)
    rl_c, _ = ref_fn(rmdl.loss_fn, rchunk, remat=False)(st.params,
                                                       jax_batch(batch))
    model.cfg = pchunk
    loss_c, _, g_c = trainer.loss_and_grads(model, tb, remat=True)
    assert rel(rl_c, loss_c.detach()) <= REL_F32, (arch, "chunked loss")
    assert rel(rloss, loss_c.detach()) <= REL_F32
    for k in g:
        assert norm_rel(g[k].numpy(), g_c[k].numpy()) <= GRAD_REL, \
            (arch, "chunked grads", k)


def ref_products(jaxpr, inside=False, times=1, out=None):
    """The ``dot_general``s of a reference jaxpr inside ``jax.checkpoint``
    (``remat2``), counted once a scan step: ``{"kept": without batch
    dims, "recomputed": with them}``."""
    out = collections.Counter() if out is None else out
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general" and inside:
            (_, _), (batch_dims, _) = e.params["dimension_numbers"]
            out["recomputed" if batch_dims else "kept"] += times
        n = times * e.params["length"] if name == "scan" else times
        for p in e.params.values():
            for j in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(j, jax.extend.core.ClosedJaxpr):
                    j = j.jaxpr
                if isinstance(j, jax.extend.core.Jaxpr):
                    ref_products(j, inside or name == "remat2", n, out)
    return out


def check_dots_keep_like_reference(arch: str, monkeypatch) -> None:
    """The products the port's ``dots`` remat keeps in a forward pass
    (``_save_dots``' answers outside the backward's recompute) are as
    many as the reference's policy keeps."""
    rcfg, pcfg = twin_configs(arch, "f32")
    assert pcfg.remat_policy == rcfg.remat_policy == "dots"
    rocfg, pocfg = opt_configs()
    st = ref_state(rcfg, rocfg, seed=0)
    batch = train_batch(rcfg, seed=1)
    want = ref_products(jax.make_jaxpr(
        lambda p, b: rmdl.loss_fn(rcfg, p, b, remat=True))(
            st.params, jax_batch(batch)).jaxpr)
    got = collections.Counter()
    save = common._save_dots

    def spy(ctx, op, *args, **kwargs):
        policy = save(ctx, op, *args, **kwargs)
        if op in common._DOTS and not ctx.is_recompute:
            got["kept" if policy == common.CheckpointPolicy.MUST_SAVE
                else "recomputed"] += 1
        return policy

    monkeypatch.setattr(common, "_save_dots", spy)
    model = interop.train_state(pcfg, pocfg, st, "cpu").params
    trainer.loss_and_grads(model, torch_batch(batch))
    assert got["kept"] == want["kept"] > 0, (arch, got, want)
    assert got["recomputed"] > 0 and want["recomputed"] > 0, (arch, got)


def ref_steps(rcfg, rocfg, state, batch, n, accum_steps=1):
    """``n`` steps of the reference's jitted train step on the same
    batch; the state goes back to numpy between steps (one compile)."""
    step = jax.jit(rtrainer.make_train_step(rcfg, rocfg, make_smoke_mesh(),
                                            TP_RULES,
                                            accum_steps=accum_steps))
    metrics = []
    for _ in range(n):
        state, m = step(state, jax_batch(batch))
        state = jax.tree.map(np.asarray, state)
        metrics.append(jax.tree.map(np.asarray, m))
    return state, metrics


def check_train_steps(arch: str) -> None:
    """Three train steps, then a step with accumulation, then eval."""
    rcfg, pcfg = twin_configs(arch, "f32")
    rocfg, pocfg = opt_configs()
    st0 = ref_state(rcfg, rocfg, seed=0)
    batch = train_batch(rcfg, seed=1)
    rst, rms = ref_steps(rcfg, rocfg, st0, batch, STEPS)
    pst = interop.train_state(pcfg, pocfg, st0, "cpu")
    step = trainer.make_train_step(pcfg, pocfg)
    tb = torch_batch(batch)
    for i in range(STEPS):
        pst, pm = step(pst, tb)
        assert set(pm) == set(rms[i]) == {"nll", "aux", "tokens", "loss",
                                         "grad_norm", "lr"}
        for k in ("loss", "nll", "aux", "tokens", "grad_norm"):
            assert rel(rms[i][k], pm[k]) <= REL_F32, (arch, i, k)
        assert float(rms[i]["lr"]) == pm["lr"].item()
    assert int(rst.opt.step) == int(pst.opt.step) == STEPS
    tree = trainer.state_tree(pst)
    assert_trees_close(rst.params, interop.lm_tree(
        dict(pst.params.named_parameters())), norm_rel,
        PARAM_REL, (arch, "params"))
    for what in ("mu", "nu"):
        assert_trees_close(getattr(rst.opt, what), getattr(tree.opt, what),
                           norm_rel, PARAM_REL, (arch, what))

    # accumulation over two microbatches, from the same start
    rst, rms = ref_steps(rcfg, rocfg, st0, batch, 1, accum_steps=2)
    pst = interop.train_state(pcfg, pocfg, st0, "cpu")
    pst, pm = trainer.make_train_step(pcfg, pocfg, accum_steps=2)(pst, tb)
    assert float(pm["aux"]) == 0.0 and float(pm["tokens"]) == B * S
    for k in ("loss", "nll", "aux", "tokens", "grad_norm", "lr"):
        assert rel(rms[0][k], pm[k]) <= REL_F32, (arch, "accum", k)
    assert_trees_close(rst.params, interop.lm_tree(
        dict(pst.params.named_parameters())), norm_rel,
        PARAM_REL, (arch, "accum params"))

    # eval: the loss without autograd
    ev = trainer.make_eval_step(pcfg)(pst.params, tb)
    loss, m = mdl.loss_fn(pst.params, tb, remat=False)
    assert not ev["loss"].requires_grad
    assert torch.equal(ev["loss"], loss.detach())
    assert set(ev) == {"nll", "aux", "tokens", "loss"}


def check_bf16_first_step(arch: str) -> None:
    rcfg, pcfg = twin_configs(arch, "bf16")
    rocfg, pocfg = opt_configs()
    st0 = ref_state(rcfg, rocfg, seed=0)
    batch = train_batch(rcfg, seed=1)
    rloss, _ = ref_fn(rmdl.loss_fn, rcfg, remat=False)(st0.params,
                                                      jax_batch(batch))
    pst = interop.train_state(pcfg, pocfg, st0, "cpu")
    pst, pm = trainer.make_train_step(pcfg, pocfg)(pst, torch_batch(batch))
    assert rel(rloss, pm["loss"]) <= twin_bound(pcfg, "bf16"), arch
    assert torch.isfinite(pm["grad_norm"])


@pytest.mark.parametrize("arch", DENSE)
def test_twin_loss_and_grads_like_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_twin_dots_remat_keeps_like_reference(arch, monkeypatch):
    check_dots_keep_like_reference(arch, monkeypatch)


@pytest.mark.parametrize("arch", DENSE)
def test_twin_train_steps_like_reference(arch):
    check_train_steps(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_twin_bf16_first_step_like_reference(arch):
    check_bf16_first_step(arch)


@pytest.mark.parametrize("arch", ["smollm_360m", "whisper_base"])
def test_serving_then_training_in_one_process(arch):
    """A model served first (under inference mode, where RoPE's and the
    sinusoidal table's cached frequencies may first be made) and then
    trained gives the gradients of training alone."""
    _, pcfg = twin_configs(arch, "f32")
    model = mdl.randomize_params(mdl.init_params(pcfg, 0, "cpu"), 3)
    batch = torch_batch(train_batch(pcfg, seed=4))
    ly._inv_freqs.cache_clear()
    _, _, alone = trainer.loss_and_grads(model, batch)
    ly._inv_freqs.cache_clear()
    pre = {k: v for k, v in batch.items() if k != "labels"}
    _, state, mem = model.prefill(pre, model.init_serve_state(B, S + 2))
    model.decode_step(batch["tokens"][:, :1], state, mem)
    _, _, after = trainer.loss_and_grads(model, batch)
    for k in alone:
        assert torch.equal(alone[k], after[k]), k


def test_train_state_round_trips_through_the_reference_layout():
    rcfg, pcfg = twin_configs("smollm_360m", "f32")
    rocfg, pocfg = opt_configs(master_copy=True)
    st0 = ref_state(rcfg, rocfg, seed=0)
    pst = interop.train_state(pcfg, pocfg, st0, "cpu")
    tree = trainer.state_tree(pst)
    for what in ("mu", "nu", "master"):
        assert_trees_close(getattr(st0.opt, what), getattr(tree.opt, what),
                           max_rel, 0.0, what)
    assert_trees_close(st0.params, interop.lm_tree(
        dict(pst.params.named_parameters())), max_rel, 0.0,
        "params")
    abstract = trainer.abstract_train_state(pcfg, pocfg)
    assert all(p.device.type == "meta" for p in abstract.params.parameters())
    for k, v in abstract.opt.mu.items():
        assert v.shape == pst.opt.mu[k].shape and v.device.type == "meta"
    assert abstract.opt.master.keys() == pst.opt.master.keys()
    with pytest.raises(ValueError):
        trainer.make_train_step(dataclasses.replace(pcfg, name="other"),
                                pocfg)(pst, {})
