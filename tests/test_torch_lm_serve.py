"""The LM zoo's configurations, parameter counts, serve-step factory,
launcher and example in the port, on the CPU.

- every port configuration, full and smoke, equals the reference's
  field by field (dtypes mapped), and so do the registry's shapes,
  skip reasons and ids; ``get`` of a CHL configuration is ``None`` in
  both packages;
- ``param_count`` and ``active_param_count`` of the ten full
  configurations (built on the meta device) equal the reference's;
- ``python -m repro_torch.launch.serve --smoke --device cpu`` serves
  every architecture: tokens [B, gen] inside the vocabulary, the first
  the prefill's argmax, the same tokens on a second run; ``--chl-index``
  answers as ``serve_chl`` does;
- ``interop.lm_params`` carries the reference's weights leaf for leaf
  and refuses a missing, extra or misshapen leaf;
- ``make_serve_fns`` runs the model's prefill and decode and refuses a
  model of another configuration; ``examples.serve_lm`` runs.
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
from repro_torch.examples import serve_lm
from repro_torch.launch import serve
from repro_torch.models import model as mdl
from repro_torch.train import make_serve_fns

torch.set_num_threads(1)

ARCHS = list(rbase.lm_arch_ids())

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def test_registry_equals_reference():
    assert pbase.ARCH_IDS == rbase.ARCH_IDS
    assert pbase.lm_arch_ids() == rbase.lm_arch_ids()
    assert [dataclasses.astuple(s) for s in pbase.SHAPES] == \
        [dataclasses.astuple(s) for s in rbase.SHAPES]
    assert pbase.SHAPE_BY_NAME.keys() == rbase.SHAPE_BY_NAME.keys()
    assert pbase.FULL_ATTENTION_SKIP == rbase.FULL_ATTENTION_SKIP
    assert issubclass(pbase.SkipCell, Exception)


@pytest.mark.parametrize("name", ["chl_road", "chl-scalefree"])
def test_chl_configs_have_no_arch_spec_like_reference(name):
    assert rbase.get(name) is None
    assert pbase.get(name) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_by_field(arch):
    ref, port = rbase.get(arch), pbase.get(arch)
    assert port.skip_shapes == ref.skip_shapes
    assert port.skip_reason("long_500k") == ref.skip_reason("long_500k")
    assert pbase.get(arch.replace("_", "-")) is port
    for r, p in ((ref.config, port.config), (ref.smoke, port.smoke)):
        rf, pf = dataclasses.asdict(r), dataclasses.asdict(p)
        assert rf.keys() == pf.keys()
        for k in rf:
            want = _DTYPES[rf[k]] if k in ("dtype", "param_dtype") else rf[k]
            assert pf[k] == want, (arch, k)
        assert p.hd == r.hd


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    ref, port = rbase.get(arch).config, pbase.get(arch).config
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def test_param_counts_pinned():
    assert pbase.get("smollm_360m").config.param_count() == 409_007_040
    qwen = pbase.get("qwen3_moe_235b_a22b").config
    assert qwen.active_param_count() == 18_839_490_560


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_smoke_on_the_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--gen", "4", "--device", "cpu"]
    out = serve.main(argv)
    toks = out["tokens"]
    cfg = pbase.get(arch).smoke
    assert toks.shape == (2, 4)
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    assert out["tok_per_s"] > 0 and out["prefill_s"] > 0
    assert "tok/s" in capsys.readouterr().out
    # the first token is the prefill's argmax under the same weights
    model = mdl.init_params(cfg, seed=0, device="cpu")
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 6)))
    batch = {"tokens": prompts}
    if cfg.family == "vision":
        batch["image_embeds"] = torch.zeros(2, cfg.n_image_tokens,
                                            cfg.d_model)
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.zeros(2, cfg.n_audio_tokens,
                                            cfg.d_model)
    logits, _, _ = model.prefill(batch, model.init_serve_state(2, 10))
    assert np.array_equal(toks[:, 0], logits.argmax(-1).numpy())
    # seeded weights and sampler: a second run gives the same tokens
    assert np.array_equal(serve.main(argv)["tokens"], toks)


def test_serve_launcher_hands_chl_index_to_serve_chl(tmp_path, capsys):
    from repro_torch.graphs import grid_road
    from repro_torch.graphs.ranking import degree_ranking
    from repro_torch.index import BuildPlan, build
    from repro_torch.launch import serve_chl
    g = grid_road(4, 5, seed=1)
    idx = build(g, degree_ranking(g), BuildPlan(algo="plant", batch=4),
                device="cpu")
    path = idx.save(str(tmp_path / "idx"))
    rest = ["--queries", "64", "--batch-size", "16", "--device", "cpu"]
    want = serve_chl.main(["--index", path] + rest)
    for argv in (["--chl-index", path] + rest,
                 rest[:2] + [f"--chl-index={path}"] + rest[2:]):
        got = serve.main(argv)
        assert np.array_equal(got["distances"], want["distances"])
        assert got["stats"]["queries"] == 64
    with pytest.raises(SystemExit, match="needs a value"):
        serve.main(["--chl-index"])


def test_make_serve_fns_runs_the_model_and_checks_its_config():
    cfg = pbase.get("jamba15_large_398b").smoke
    model = mdl.init_params(cfg, seed=3, device="cpu")
    prefill_fn, decode_fn = make_serve_fns(cfg)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256,
                                                               (2, 9)))
    logits, state, mem = prefill_fn(model, {"tokens": tokens[:, :8]},
                                    model.init_serve_state(2, 12))
    assert mem is None and state["pos"] == 8
    want, _, _ = model.prefill({"tokens": tokens[:, :8]},
                               model.init_serve_state(2, 12))
    assert torch.equal(logits, want)
    step, state = decode_fn(model, tokens[:, 8:], state)
    assert step.shape == (2, cfg.vocab) and state["pos"] == 9
    other = make_serve_fns(pbase.get("smollm_360m").smoke)[0]
    with pytest.raises(ValueError, match="smollm"):
        other(model, {"tokens": tokens}, model.init_serve_state(2, 12))


def test_serve_lm_example_runs_on_the_cpu(capsys):
    out = serve_lm.main(device="cpu")
    assert out["tokens"].shape == (4, 48)
    assert "decode  47 steps × 4 seqs" in capsys.readouterr().out


def test_lm_params_carries_every_leaf_and_refuses_mismatches():
    cfg = rbase.get("llama32_vision_90b").smoke
    params, _ = rmdl.init_params(cfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    model = interop.lm_params(pbase.get("llama32_vision_90b").smoke, tree,
                              device="cpu")
    assert torch.equal(model.dec.groups[1].blk4.attn.wq,
                       torch.as_tensor(tree["dec"]["blk4"]["attn"]["wq"][1]))
    assert torch.equal(model.embed.out,
                       torch.as_tensor(tree["embed"]["out"]))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    pcfg = pbase.get("llama32_vision_90b").smoke
    missing = dict(tree, final_ln={})
    extra = dict(tree, spare={"w": np.zeros(3, np.float32)})
    bad = jax.tree.map(lambda a: a, tree)
    bad["dec"]["blk0"]["mlp"]["wo"] = bad["dec"]["blk0"]["mlp"]["wo"][:, 1:]
    for tree_, match in ((missing, "no reference leaf"),
                         (extra, "not in the port"), (bad, "shape")):
        with pytest.raises(ValueError, match=match):
            interop.lm_params(pcfg, tree_, device="cpu")
