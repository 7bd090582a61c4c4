"""Transformer-decode launcher of the port: batched greedy decode.

Runs greedy decoding with the KV-cache ``serve_step`` over a batch of
synthetic prompts, with the reference launcher's flags and printout
(``repro/launch/serve_decode.py``): the prompt is filled by sequential
decode, then ``--gen`` tokens are generated. ``--device`` (default
``cuda``; raises without a card) picks the device; ``--full`` takes the
architecture's full config (``get_arch``) in place of its CPU-sized
reduced one. ``--arch`` takes every name of the registry: the dense
configs, qwen3-moe-30b-a3b and arctic-480b (MoE), mamba2-1.3b (SSD),
recurrentgemma-9b (RG-LRU and local attention), seamless-m4t-medium
(enc-dec) and qwen2-vl-72b (M-RoPE); arctic-480b's full width needs
expert parallelism over several cards and runs only reduced, and
qwen2-vl-72b's 80 layers (145 GB of bf16 weights) do not fit one card
at ``--full``. As in the reference launcher, an enc-dec model decodes
against cross caches of ``SOURCE_SLOTS`` empty source positions (``x_len =
0``: the cross-attention adds 0), and M-RoPE takes the position of each
step on all three streams. Weights are random, from ``torch.Generator``
seeded with ``--seed``. On the card every attention layer of a step is
one ``flash_decode`` launch (two in an enc-dec block: self and cross);
SSD and RG-LRU layers update their states in place.

  PYTHONPATH=src python -m repro_torch.launch.serve_decode --device cpu \
      --arch gemma2-2b --batch 4 --prompt-len 16 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_decode --full \
      --arch recurrentgemma-9b --batch 8
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch, get_reduced
from repro_torch.data.pipeline import zipf_tokens
from repro_torch.device import resolve_device
from repro_torch.graph.sampler import rng_from
from repro_torch.models.transformer import (init_decode_state, init_params,
                                            serve_step)

#: the enc-dec model's source positions in the launcher's (empty) cross
#: caches, as the reference launcher's
SOURCE_SLOTS = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_decode(cfg, params, prompts: np.ndarray, gen: int,
                  device: torch.device, states: Optional[dict] = None,
                  mesh=None
                  ) -> Tuple[np.ndarray, float, List[torch.Tensor]]:
    """prompts (B, P) int32 -> (token ids (B, P + gen) int32, wall
    seconds of the decode loop, the logits of each step). Step t feeds
    token t at position t (on all three M-RoPE streams where the config
    has them); past the prompt the next token is the argmax of the
    step's logits, as the reference launcher does. ``states``: a fresh
    ``init_decode_state`` of ``max_len = P + gen`` (an enc-dec model's
    with its cross caches written in); default one made here, with
    ``SOURCE_SLOTS`` empty source positions for enc-dec. ``mesh``: each
    step's ``serve_step`` over that ``("data", "model")`` mesh."""
    B, prompt_len = prompts.shape
    max_len = prompt_len + gen
    if states is None:
        states = init_decode_state(
            cfg, B, max_len=max_len, device=device,
            src_len=SOURCE_SLOTS if cfg.kind == "encdec" else 0)
    prompts_t = torch.from_numpy(np.ascontiguousarray(prompts)).to(device)
    logits_seen = []
    _sync(device)
    t0 = time.perf_counter()
    tok = prompts_t[:, :1]
    out_tokens = [tok]
    with torch.inference_mode():
        for t in range(max_len - 1):
            pos = torch.full((B,), t, dtype=torch.int32, device=device)
            mp = (pos[None, :, None].expand(3, B, 1)
                  if cfg.mrope_sections else None)
            logits, states = serve_step(cfg, params, states, tok, pos,
                                        mrope_positions=mp, mesh=mesh)
            logits_seen.append(logits[:, -1])
            if t + 1 < prompt_len:
                tok = prompts_t[:, t + 1:t + 2]
            else:
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out_tokens.append(tok)
    tokens = torch.cat(out_tokens, dim=1).cpu().numpy()   # synchronises
    _sync(device)
    return tokens, time.perf_counter() - t0, logits_seen


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full config, not the reduced")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch) if args.full else get_reduced(args.arch)
    gen_device = device if device.type == "cuda" else torch.device("cpu")
    params = init_params(
        cfg, torch.Generator(device=gen_device).manual_seed(args.seed),
        device)
    B = args.batch

    rng = rng_from(args.seed)   # RNG-CONTRACT: keyed Philox stream
    prompts = zipf_tokens(rng, cfg.vocab_size, (B, args.prompt_len))

    gen, dt, _ = greedy_decode(cfg, params, prompts, args.gen, device)
    steps = args.prompt_len + args.gen - 1
    print(f"== serve {args.arch} ({'full' if args.full else 'reduced'}) "
          f"on {device.type} ==")
    print(f"batch {B}  prompt {args.prompt_len}  gen {args.gen}")
    print(f"{steps} decode steps in {dt:.2f}s "
          f"({1e3 * dt / steps:.1f} ms/step, "
          f"{B * steps / dt:.0f} tok/s aggregate)")
    print("sample token ids:", gen[0, args.prompt_len:
                                   args.prompt_len + 10].tolist())
    assert np.isfinite(gen).all()


if __name__ == "__main__":
    main()
