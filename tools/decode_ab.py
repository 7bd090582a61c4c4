#!/usr/bin/env python3
"""Time the bfloat16 ``flash_decode`` of two or more checkouts of the port
in turns, on one card, at the served models' decode shapes.

    python3 tools/decode_ab.py OLD/src NEW/src \
        NEW/src:SPLIT_BYTES=524288 OLD/src

Each argument is a ``src`` directory holding ``repro_torch``, optionally
followed by ``:NAME=VALUE,...``: constants of
``repro_torch/kernels/flash_decode/flash_decode.py`` (the split plan's
``SPLIT_BYTES``, ``MAX_SPLITS``, ``FULL_BLOCKS_PER_SM``) set before the
run, to compare plans of one kernel. Each runs in a process of its own
(its kernels built from its own sources), in the order given, over the
same seeded inputs: gemma2-2b's long ragged cache (16, 32768, 4, 256),
recurrentgemma-9b's window (8, 2048, 1, 256), qwen3-moe-30b-a3b's (8,
4096, 4, 128) and its sharded call folded at tp = 4 (32, 1024, 4, 128),
qwen2-vl-72b's (8, 8192, 8, 128), seamless-m4t-medium's self (8, 8192,
16, 64) and ragged cross (8, 4096, 16, 64) caches, the decode loops'
48-slot caches, and two head widths 16 does not divide. Per run it
prints one JSON line: per shape the call's time one call a CUDA-graph
replay (``ms``) and a call in a graph of 20 (``ms_graph``), the card
operations a call, the split plan, the byte bound at 3.35 TB/s, SDPA's
time (``enable_gqa``, the yardstick) where the lengths are full, and
whether the result is within ``rtol=1e-4, atol=1e-5`` of the plain
version and bit-equal on a second call; and the card's name and power
limit. Unpack the parent with ``git archive`` into a git-ignored
directory such as ``build/parent`` for OLD.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: name: (B, S, H, kvH, dh, softcap, lengths)
SHAPES = {
    "gemma2_long": (16, 32768, 8, 4, 256, 50.0, "long"),
    "gemma2_loop": (8, 48, 8, 4, 256, 50.0, "full"),
    "recurrentgemma_window": (8, 2048, 16, 1, 256, 0.0, "full"),
    "recurrentgemma_loop": (8, 48, 16, 1, 256, 0.0, "full"),
    "qwen3_moe": (8, 4096, 32, 4, 128, 0.0, "full"),
    "qwen3_moe_loop": (8, 48, 32, 4, 128, 0.0, "full"),
    "qwen3_moe_folded_tp4": (32, 1024, 32, 4, 128, 0.0, "partials"),
    "qwen2_vl": (8, 8192, 64, 8, 128, 0.0, "full"),
    "qwen2_vl_loop": (8, 48, 64, 8, 128, 0.0, "full"),
    "seamless_self": (8, 8192, 16, 16, 64, 0.0, "full"),
    "seamless_self_loop": (8, 48, 16, 16, 64, 0.0, "full"),
    "seamless_cross": (8, 4096, 16, 16, 64, 0.0, "cross"),
    "g24_dh72": (3, 300, 48, 2, 72, 30.0, "ragged"),
    "g16_dh48": (3, 777, 32, 2, 48, 0.0, "ragged"),
}


def lengths(torch, dev, B, S, kind):
    """(length, start) of a shape: chip_smoke.py's long cache, the cross
    caches' 4096 - 97 b, a ragged pair, or full lengths."""
    i32 = dict(dtype=torch.int32, device=dev)
    if kind == "long":
        lens = [S, S, 1, 0, S // 2, S - 1, 4097, 3, S, 1000, S, 2, 20000, S,
                12345, S][:B]
        starts = [0, S - 4096, 0, 0, S // 2 - 4096, 1, 1, 3, S // 3, 999, 0,
                  0, 0, S - 1, 0, 5][:B]
        return torch.tensor(lens, **i32), torch.tensor(starts, **i32)
    if kind == "cross":
        return (S - 97 * torch.arange(B, device=dev)).to(torch.int32), None
    if kind == "ragged":
        return (torch.tensor([S, S // 3, 1][:B], **i32),
                torch.tensor([0, 5, 0][:B], **i32))
    return torch.full((B,), S, **i32), None


def child(spec: str) -> dict:
    src, _, over = spec.partition(":")
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, ROOT)
    sys.path.insert(0, src)
    from chip_smoke import (MEM_BYTES_PER_S, card_line, device_ms,
                            device_ms_per_call, device_ops)
    from repro_torch.kernels.flash_decode import flash_decode as fdm
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.kernels.flash_decode.ref import (
        finalize, flash_decode_batched_ref)
    for item in filter(None, over.split(",")):
        name, value = item.split("=")
        setattr(fdm, name, float(value) if "." in value else int(value))
    dev = torch.device("cuda", 0)
    out = {"src": spec, "card": card_line()}
    for name, (B, S, H, kvH, dh, cap, kind) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(
            name.encode()))
        bf = dict(dtype=torch.bfloat16, device=dev, generator=gen)
        q = torch.randn((B, H, dh), **bf)
        k, v = (torch.randn((B, S, kvH, dh), **bf) for _ in range(2))
        ln, st = lengths(torch, dev, B, S, kind)
        want = flash_decode_batched_ref(q, k, v, ln, st, softcap=cap)
        if kind == "partials":
            def fn():
                return ops.flash_decode_partials(q, k, v, ln, st, softcap=cap)
        else:
            def fn():
                return ops.flash_decode_batched(q, k, v, ln, st, softcap=cap)
            want = (finalize(want[0], want[2]),)
        got, again = fn(), fn()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        valid = int((ln.clamp(max=S) - (0 if st is None else st.clamp(
            min=0))).clamp(min=0).sum())
        r = {"ok": all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                       for a, b in zip(got, want)),
             "same": all(torch.equal(a, b) for a, b in zip(got, again)),
             "max_abs_err": max(float((a - b).abs().max())
                                for a, b in zip(got, want)),
             "ms": device_ms(torch, fn),
             "ms_graph": device_ms_per_call(torch, fn),
             "card_ops": len(device_ops(torch, fn)),
             "bound_ms": 1e3 * (2 * valid * kvH * dh * 2 + q.numel() * 2
                                + B * H * dh * 4) / MEM_BYTES_PER_S}
        if hasattr(fdm, "launch_plan"):
            r["plan"] = fdm.launch_plan(B, S, H, kvH, dh, torch.bfloat16,
                                        fdm.multiprocessors(dev))
        if kind in ("full", "partials"):
            qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      enable_gqa=True)
            r["sdpa_ms"] = device_ms(torch, sdpa)
            r["sdpa_ms_graph"] = device_ms_per_call(torch, sdpa)
        out[name] = r
        del q, k, v, want, got, again
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for spec in sys.argv[1:]:
        p = subprocess.run([sys.executable, __file__, "--child", spec],
                           timeout=900)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
