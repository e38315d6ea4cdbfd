"""Batched greedy server: prefill + greedy decode with the model's caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --batch 4 --prompt-len 256 --gen 64            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The port of ``repro.launch.serve`` for every architecture: the dense, MoE
and VLM transformers (KV caches, rolling buffers on windowed layers; a
decode step's MoE dispatch is dropless; the VLM serves text), mamba2
(constant-size conv and SSD states), zamba2 (both) and the
encoder-decoder (its encoder runs once over ``prompt-len`` speech frames
into the cache, then the decoder prefills and decodes).  Weights, prompts
and frames are random, drawn from ``--seed``.  mixtral-8x7b (93 GB) and
grok-1-314b (628 GB) do not fit one card at their published depth: serve
a config with fewer layers through ``generate``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.dsarray import resolve_device
from repro_torch.models.model import Model, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_into_cache(model: Model, params, cache, tokens: torch.Tensor):
    """Feed a prompt token by token through ``decode_step`` (simple, and it
    exercises the cache path; a production server would prefill with the
    full-sequence forward)."""
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1])
    return logits, cache


@torch.inference_mode()
def generate(model: Model, params, prompt: torch.Tensor, gen: int,
             frames: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Greedy decode of ``gen`` tokens after ``prompt`` (B, T): returns the
    new tokens (B, gen) and the host-clock seconds of the prefill and of the
    decode (each ending in a device sync).  An encoder-decoder takes its
    encoder ``frames`` (B, T_enc, F): they are encoded once into the cache,
    inside the prefill's time."""
    b, t = prompt.shape
    kw = {} if frames is None else {"enc_len": frames.shape[1]}
    cache = model.init_cache(b, t + gen, device=prompt.device, **kw)
    t0 = time.perf_counter()
    if frames is not None:
        cache["enc_out"] = model.module.encode(params, model.cfg, frames)
    logits, cache = prefill_into_cache(model, params, cache, prompt)
    _sync(prompt.device)
    prefill_s = time.perf_counter() - t0
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode_step(params, cache, tok)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out.append(tok)
    _sync(prompt.device)
    return torch.cat(out, dim=1), {"prefill_s": prefill_s,
                                   "decode_s": time.perf_counter() - t0}


def main(argv=None) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Serve ``--batch`` random prompts: returns the new tokens (B, gen) and
    the prefill and decode seconds."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = model.init(gen, device)
        prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                               generator=gen, device=device)
        frames = None
        if cfg.family == "encdec":
            frames = torch.randn((args.batch, args.prompt_len, cfg.frontend_dim),
                                 generator=gen, device=device)
    tokens, times = generate(model, params, prompt, args.gen, frames)
    tps = args.batch * (args.gen - 1) / max(times["decode_s"], 1e-9)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={device}")
    print(f"prefill {times['prefill_s']:.2f}s, decode {times['decode_s']:.2f}s "
          f"({tps:.1f} tok/s)")
    print("sample:", tokens[0, :16].tolist())
    return tokens, times


if __name__ == "__main__":
    main()
