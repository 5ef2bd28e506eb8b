"""Batched LM serving: prefill + KV-cache decode with one API, the port of
the JAX package's ``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen2-7b
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu

``serve`` runs greedy decoding at an architecture's smoke config: the
prompt's prefill (its attention on K9 on the card), then ``gen - 1`` decode
steps, each feeding back the argmax. It runs on the card unless ``device``
names another (``device.resolve_device``). ``main`` serves the example's
architectures that the port has: qwen3-14b (full attention) and
recurrentgemma-2b (RG-LRU + a ring window); xlstm-125m and whisper-base
wait for their slices and are named as such.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import LATER

EXAMPLE_ARCHS = ("qwen3-14b", "recurrentgemma-2b", "xlstm-125m",
                 "whisper-base")


def make_batch(cfg, batch_size: int, prompt: int, device, seed: int = 1):
    """Prompt tokens (and the vlm's patch embeddings) drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, prompt),
                                     generator=gen, dtype=torch.int32,
                                     device=device)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (batch_size, cfg.num_patches, cfg.d_model), generator=gen,
            device=device).to(torch.bfloat16)
    return batch


def generate(api, params, batch, gen: int, pad_cache_to: int):
    """Greedy: the prefill's argmax, then ``gen - 1`` decode steps.
    Returns ((B, gen) int32 tokens, [prefill logits, step logits ...])."""
    logits, state = api.prefill(params, batch, pad_cache_to=pad_cache_to)
    tok = torch.argmax(logits, -1).to(torch.int32)
    outs, all_logits = [tok], [logits]
    for _ in range(gen - 1):
        logits, state = api.decode_step(params, state, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
        outs.append(tok)
        all_logits.append(logits)
    return torch.stack(outs, 1), all_logits


def serve(arch, batch_size=4, prompt=24, gen=12, device=None, *,
          params=None, batch=None):
    """Greedy prefill + decode of ``arch``'s smoke config; prints the
    example's line and returns the (B, gen) tokens. ``params`` and
    ``batch`` default to draws from seeds 0 and 1, as the example's."""
    cfg = get_smoke_config(arch)
    api = build_model(cfg)
    dev = resolve_device(device)
    if params is None:
        params = api.init(0, device=dev)
    if batch is None:
        batch = make_batch(cfg, batch_size, prompt, dev, seed=1)
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    t0 = time.time()
    toks, _ = generate(api, params, batch, gen, extra + prompt + gen)
    toks = toks.cpu()                       # waits for the device
    print(f"{arch:22s} {batch_size}x{prompt}+{gen}: "
          f"{time.time() - t0:5.1f}s  sample={toks[0, :6].tolist()}")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser(description="batched LM serving example")
    ap.add_argument("--arch", choices=ARCH_IDS, action="append",
                    help="an architecture (repeatable); default: the "
                         "example's four")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    args = ap.parse_args(argv)
    for arch in args.arch or EXAMPLE_ARCHS:
        family = get_smoke_config(arch).family
        if family in ("moe", "ssm", "audio"):
            print(f"{arch:22s} not ported yet: {LATER[family]}")
            continue
        serve(arch, args.batch, args.prompt, args.gen, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
