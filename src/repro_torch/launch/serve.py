"""Serving launcher: batched LM decode with prefill and sampling.

    python -m repro_torch.launch.serve --arch smollm_360m \
        --batch 4 --prompt-len 32 --gen 64

Runs on ``--device`` (default: the card; it raises without CUDA;
``--device cpu`` runs on the CPU). ``--smoke`` takes the
architecture's reduced twin. Weights are random, drawn from a
``torch.Generator`` on the device seeded with 0; prompts are the
reference's (``numpy.random.default_rng(0)``). The first generated
token is the argmax; the rest are sampled at ``--temperature`` from a
``torch.Generator`` seeded with 1, as the reference seeds its key
(sampled tokens are not ``jax.random``'s).

CHL query serving sits behind the index artifact API: ``--chl-index
<dir>`` hands off to ``repro_torch.launch.serve_chl`` with the rest of
the arguments forwarded.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.device import resolve_device
from repro_torch.models import model as mdl
from repro_torch.train.trainer import make_serve_fns


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    raw = list(sys.argv[1:] if argv is None else argv)
    for i, a in enumerate(raw):              # CHL artifact serving path
        if a == "--chl-index" or a.startswith("--chl-index="):
            from repro_torch.launch.serve_chl import main as chl_main
            if "=" in a:
                val = a.split("=", 1)[1]
                rest = raw[:i] + raw[i + 1:]
            elif i + 1 < len(raw):
                val = raw[i + 1]
                rest = raw[:i] + raw[i + 2:]
            else:
                raise SystemExit(
                    "repro_torch.launch.serve: --chl-index needs a value "
                    "(the CHLIndex artifact directory)")
            return chl_main(["--index", val] + rest)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    args = ap.parse_args(raw)

    dev = resolve_device(args.device)
    spec = cfgbase.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    params = mdl.init_params(cfg, seed=0, device=dev)
    prefill_fn, decode_fn = make_serve_fns(cfg)

    rng = np.random.default_rng(0)
    B = args.batch
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, args.prompt_len)), device=dev)
    batch = {"tokens": prompts}
    if cfg.family == "vision":
        batch["image_embeds"] = torch.zeros(
            (B, cfg.n_image_tokens, cfg.d_model), device=dev)
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.zeros(
            (B, cfg.n_audio_tokens, cfg.d_model), device=dev)

    state = mdl.init_serve_state(cfg, B, args.prompt_len + args.gen, dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, state, mem = prefill_fn(params, batch, state)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out_tokens = [tok]
    finite = bool(torch.isfinite(logits).all())
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, state = decode_fn(params, tok, state, mem)
        probs = torch.softmax(logits.float() / args.temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=gen)
        out_tokens.append(tok)
    tokens = torch.cat(out_tokens, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t0
    finite = finite and bool(torch.isfinite(logits).all())
    steps = args.gen - 1
    tps = B * steps / max(t_decode, 1e-9)
    ms_step = 1e3 * t_decode / max(steps, 1)
    print(f"prefill {args.prompt_len} toks × {B} seqs: {t_prefill:.3f}s")
    print(f"decode  {steps} steps × {B} seqs: {t_decode:.3f}s "
          f"({ms_step:.2f} ms/step, {tps:.1f} tok/s)")
    print(f"sample tokens[0,:16] = {tokens[0, :16].tolist()}")
    if not finite:
        raise FloatingPointError(f"{cfg.name}: non-finite logits")
    return {"tokens": tokens, "tok_per_s": tps, "prefill_s": t_prefill,
            "decode_s": t_decode, "ms_per_step": ms_step}


if __name__ == "__main__":
    main()
