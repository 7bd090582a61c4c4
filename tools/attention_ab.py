#!/usr/bin/env python3
"""Time the bfloat16 ``flash_attention`` (prefill) of two or more
checkouts of the port in turns, on one card, at the served models' shapes.

    python3 tools/attention_ab.py OLD/src NEW/src NEW/src OLD/src

Each argument is a ``src`` directory holding ``repro_torch``. Each runs
in a process of its own (its kernels built from its own sources), in the
order given, over the same seeded inputs: the first attention layers of
gemma2-2b (local, window 4096, and global; (1, 8192, 8, 256), 4 kv
heads, softcap 50), recurrentgemma-9b (local, (1, 8192, 16, 256), one kv
head, window 2048), qwen3-moe-30b-a3b ((1, 4096, 32, 128), 4 kv heads),
qwen2-vl-72b ((1, 8192, 64, 128), 8 kv heads) and seamless-m4t-medium
(self-attention (1, 8192, 16, 64), the encoder's (1, 4096, 16, 64)
without a mask, and cross-attention over 4096 keys). Per run it prints
one JSON line: per shape the call's time one call a CUDA-graph replay
(``ms``) and a call in a graph of 20 (``ms_graph``), the host's time to
enqueue one eager call (``host_us``), the card operations a call, the
operations bound (4 dh FLOP a valid pair at 989 TFLOP/s) and its share,
SDPA's time (``enable_gqa``, the same mask, no softcap: the yardstick),
whether the result is within ``rtol=2^-7, atol=1e-5`` of the plain
version (``ok``) and bit-equal on a second call (``same``); and the
card's name and power limit. Unpack the parent with ``git archive`` into
a git-ignored directory such as ``build/parent`` for OLD.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: name: (S, Skv, H, kvH, dh, causal, window, softcap)
SHAPES = {
    "gemma2_local": (8192, 8192, 8, 4, 256, True, 4096, 50.0),
    "gemma2_global": (8192, 8192, 8, 4, 256, True, 0, 50.0),
    "recurrentgemma_local": (8192, 8192, 16, 1, 256, True, 2048, 0.0),
    "qwen3_moe": (4096, 4096, 32, 4, 128, True, 0, 0.0),
    "qwen2_vl": (8192, 8192, 64, 8, 128, True, 0, 0.0),
    "seamless_self": (8192, 8192, 16, 16, 64, True, 0, 0.0),
    "seamless_encoder": (4096, 4096, 16, 16, 64, False, 0, 0.0),
    "seamless_cross": (8192, 4096, 16, 16, 64, False, 0, 0.0),
}
BF16_FLOPS_PER_S = 989e12


def valid_pairs(S: int, Skv: int, causal: bool, window: int) -> int:
    """Valid (query, key) pairs of one head."""
    if not causal:
        return S * Skv
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def child(src: str) -> dict:
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, ROOT)
    sys.path.insert(0, src)
    from chip_smoke import card_line, device_ms, device_ms_per_call, \
        device_ops
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dev = torch.device("cuda", 0)
    out = {"src": src, "card": card_line()}
    for name, (S, Skv, H, kvH, dh, causal, window, cap) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(
            name.encode()))
        bf = dict(dtype=torch.bfloat16, device=dev, generator=gen)
        q = torch.randn((1, S, H, dh), **bf)
        k, v = (torch.randn((1, Skv, kvH, dh), **bf) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=cap)

        def fn():
            return ops.flash_attention(q, k, v, **kw)
        got, again = fn(), fn()
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        flop = 4 * dh * H * valid_pairs(S, Skv, causal, window)
        r = {"ok": bool(torch.allclose(got.float(), want.float(),
                                       rtol=2 ** -7, atol=1e-5)),
             "same": bool(torch.equal(got, again)),
             "max_abs_err": float((got.float() - want.float()).abs().max()),
             "ms": device_ms(torch, fn, iters=10),
             "ms_graph": device_ms_per_call(torch, fn, calls=20, iters=3),
             "host_us": host_us,
             "card_ops": len(device_ops(torch, fn)),
             "bound_ms": 1e3 * flop / BF16_FLOPS_PER_S}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            ip = torch.arange(S, device=dev)
            sdpa_kw = {"attn_mask": (ip[None, :] <= ip[:, None])
                       & (ip[None, :] > ip[:, None] - window)}
        else:
            sdpa_kw = {"is_causal": causal}

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True, **sdpa_kw)
        r["sdpa_ms"] = device_ms(torch, sdpa, iters=10)
        out[name] = r
        del q, k, v, got, again, want
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for src in sys.argv[1:]:
        p = subprocess.run([sys.executable, __file__, "--child", src],
                           timeout=900)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
