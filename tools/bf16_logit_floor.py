"""How far the bf16 logits of a decode step move when every attention
output moves by a relative epsilon, against a real fault (a block of
keys dropped): the floor under which no whole-step comparison of two
bf16 runs can hold them (``chip_smoke.py`` ``LONG_LOGIT_SHARE``).

    PYTHONPATH=src python tools/bf16_logit_floor.py     # CPU, about 20 s

gemma2-2b (26 layers) and granite-3-2b (40 layers) at full depth and
their own heads, window and softcaps, narrowed to d_model 768 and a
2048-token vocabulary so that the CPU runs them; the caches (8192 and
4096 slots) filled from a seed, one ``serve_step`` at the last position.
Each attention output is multiplied by (1 + amp * N(0, 1)) before its
bf16 cast, for amp 1e-7 to 1e-4, three draws each; then the last 1/64
of the keys is dropped instead. One JSON line an arch: the largest
|logit difference| over the largest |logit|, a draw each.
"""
import dataclasses
import json

import torch

import repro_torch.models.transformer.attention as attention
from repro_torch.configs import get_arch, get_reduced
from repro_torch.models.transformer import (init_decode_state, init_params,
                                            serve_step)

CASES = (("gemma2-2b", 8192), ("granite-3-2b", 4096))
AMPS = (1e-7, 1e-6, 1e-5, 1e-4)


def main() -> None:
    real = attention.flash_decode_batched
    for name, S in CASES:
        full, small = get_arch(name), get_reduced(name)
        cfg = dataclasses.replace(
            small, dtype="bfloat16", d_model=768, vocab_size=2048,
            num_layers=full.num_layers, num_heads=full.num_heads,
            num_kv_heads=full.num_kv_heads, head_dim=full.head_dim,
            window=full.window, attn_softcap=full.attn_softcap,
            final_softcap=full.final_softcap)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        states = init_decode_state(cfg, 1, S)
        gen = torch.Generator().manual_seed(1)
        for st in states["scan"]:
            for k in ("k", "v"):
                st[k].copy_(torch.randn(st[k].shape, generator=gen))
        tok = torch.tensor([[7]])
        pos = torch.tensor([S - 1], dtype=torch.int32)

        def step():
            with torch.inference_mode():
                return serve_step(cfg, params, states, tok, pos)[0]
        base = step().clone()
        top = float(base.abs().max())
        out = {"arch": name, "layers": cfg.num_layers, "cache": S,
               "max_logit": top, "perturbed": {}}
        try:
            for amp in AMPS:
                shares = []
                for draw in range(3):
                    g = torch.Generator().manual_seed(100 + draw)

                    def noisy(*a, _g=g, _amp=amp, **kw):
                        o = real(*a, **kw)
                        return o * (1 + _amp * torch.randn(o.shape,
                                                           generator=_g))
                    attention.flash_decode_batched = noisy
                    shares.append(float((step() - base).abs().max()) / top)
                out["perturbed"][str(amp)] = shares

            def dropped(q, k, v, length, start=None, **kw):
                return real(q, k, v, length - k.shape[1] // 64, start, **kw)
            attention.flash_decode_batched = dropped
            out["keys_dropped_1_64"] = float((step() - base).abs().max()) / top
        finally:
            attention.flash_decode_batched = real
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
