"""The arithmetic of the bfloat16 ``flash_attention`` kernel
(``csrc/flash_attention_wgmma.cu``), emulated on the CPU and held to the
card's gates before the kernel itself runs.

The kernel computes S = q.k^T on bf16 tensor cores (warpgroup MMA) with
float32 accumulators (bf16 x bf16 products are exact in float32), applies
the scale to the float32 sum, then the softcap, and keeps the online max
and sum in float32 in base 2. P.V splits p into two bf16 terms, ``p_hi =
bf16(p)`` and ``p_lo = bf16(p - p_hi)``, each multiplied with the exact
bf16 V and accumulated in float32. ``emulate_mma`` repeats that over the
kernel's own walk: 128 flattened (query, group head) rows a block, 64 of
them a consumer warpgroup, each warpgroup over the block's key tiles
(``key_tile``: 128 keys at dh <= 128, 64 at dh = 256) from the window's
first key to the causal last (the last of k/v's own length without a
mask).

At gemma2-2b's G = 2, dh = 256 and softcap 50, with and without a window,
and at the dh 64 and 128 instances' groups (G = 1, 3, 8; causal,
windowed, and cross-attention over keys of another length), the
emulation is held against ``flash_attention_ref`` and, where k/v have
q's length, against the Pallas kernel in interpret mode: the bf16 output
within ``rtol=2**-7, atol=1e-5`` (the card's gate: one bf16 step), and
the float32 output before the cast within ``rtol=1e-4, atol=1e-5`` of
the same function on the same (bf16-valued) inputs in float32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as j_pallas_attn)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
BR = 128                  # the kernel's rows a block
WG_ROWS = 64              # a consumer warpgroup's rows: wgmma's M
LOG2E = 1.4426950408889634
G, KVH, DH, SOFTCAP = 2, 2, 256, 50.0

#: (S, window) -> Pallas tiles (tq, tk) that divide S
CASES = {(77, 0): (77, 11), (77, 50): (77, 11), (300, 0): (100, 60),
         (300, 50): (100, 60)}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value, kept in float32."""
    return x.to(torch.bfloat16).float()


def key_tile(dh: int) -> int:
    """Keys a tile of the kernel (``key_tile`` in the CUDA source)."""
    return 64 if dh > 128 else 128


def emulate_mma(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                split_p=True):
    """The kernel's arithmetic on bf16 q (B,S,H,dh), k/v (B,Skv,kvH,dh)
    (Skv == S unless there is no mask): the float32 output before the
    cast to bf16. ``split_p=False`` rounds p to bf16 once (no ``p_lo``)."""
    B, S, H, dh = q.shape
    BK = key_tile(dh)
    Skv, kvH = k.shape[1], k.shape[2]
    g_ = H // kvH
    nrows = S * g_
    scale = dh ** -0.5 if scale is None else scale
    c1 = scale / softcap if softcap > 0 else scale * LOG2E
    c2 = softcap * LOG2E
    out = torch.empty((B, kvH, nrows, dh))
    for b in range(B):
        for h in range(kvH):
            qf = q[b, :, h * g_:(h + 1) * g_].float().reshape(nrows, dh)
            kf, vf = k[b, :, h].float(), v[b, :, h].float()
            for f0 in range(0, nrows, BR):
                # the block's key tiles, walked by each of its warpgroups
                qlo, qhi = f0 // g_, (min(f0 + BR, nrows) - 1) // g_
                klo = max(0, qlo - window + 1) if window > 0 else 0
                khi = qhi if causal else Skv - 1
                for w0 in range(f0, min(f0 + BR, nrows), WG_ROWS):
                    rows = qf[w0:w0 + WG_ROWS]
                    qpos = torch.arange(w0, w0 + rows.shape[0]) // g_
                    out[b, h, w0:w0 + WG_ROWS] = _warpgroup(
                        rows, qpos, kf, vf, klo, khi, BK, c1, c2, causal,
                        window, softcap, split_p)
    return out.reshape(B, kvH, S, g_, dh).permute(0, 2, 1, 3, 4).reshape(
        B, S, H, dh)


def _warpgroup(rows, qpos, kf, vf, klo, khi, BK, c1, c2, causal, window,
               softcap, split_p):
    """One warpgroup's rows over key tiles klo.. khi: the online softmax
    in base 2 and P.V in one or two bf16 terms of p."""
    Skv, dh = kf.shape
    m = torch.full((rows.shape[0],), -1e30)
    l = torch.zeros(rows.shape[0])
    acc = torch.zeros((rows.shape[0], dh))
    for k0 in range(klo, khi + 1, BK):
        kp = torch.arange(k0, k0 + BK)
        inside = kp < Skv
        kt, vt = torch.zeros((BK, dh)), torch.zeros((BK, dh))
        kt[inside], vt[inside] = kf[kp[inside]], vf[kp[inside]]
        x = (rows @ kt.T) * c1
        if softcap > 0:
            x = torch.tanh(x) * c2
        valid = inside[None, :].expand_as(x)
        if causal:
            valid = valid & (kp[None, :] <= qpos[:, None])
        if window > 0:
            valid = valid & (kp[None, :] > qpos[:, None] - window)
        x = torch.where(valid, x, -torch.inf)
        mn = torch.maximum(m, x.amax(dim=1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(x - mn[:, None])
        l = l * alpha + p.sum(dim=1)
        p_hi = _bf16(p)
        acc = acc * alpha[:, None] + p_hi @ vt
        if split_p:
            acc = acc + _bf16(p - p_hi) @ vt
        m = mn
    return acc / l.clamp(min=1e-30)[:, None]


def _inputs(S):
    """bf16 q/k/v from a seed, q scaled so the softcap bends the scores."""
    rng = np.random.default_rng(1000 + S)
    q = rng.normal(size=(1, S, KVH * G, DH)) * 8.0
    k = rng.normal(size=(1, S, KVH, DH))
    v = rng.normal(size=(1, S, KVH, DH))
    return [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for a in (q, k, v)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S,window", sorted(CASES))
def test_emulated_mma_matches_plain_version(S, window):
    q, k, v = _inputs(S)
    kw = dict(causal=True, window=window, softcap=SOFTCAP)
    emu = emulate_mma(q, k, v, **kw)
    _close(emu.to(torch.bfloat16).float(),
           flash_attention_ref(q, k, v, **kw).float(), BF16_TOL)
    _close(emu, flash_attention_ref(q.float(), k.float(), v.float(), **kw),
           TOL)


@pytest.mark.parametrize("S,window", sorted(CASES))
def test_emulated_mma_matches_pallas_interpret(S, window):
    q, k, v = _inputs(S)
    tq, tk = CASES[(S, window)]
    kw = dict(causal=True, window=window, softcap=SOFTCAP)
    emu = emulate_mma(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    want = j_pallas_attn(*(t.astype(jnp.bfloat16) for t in (jq, jk, jv)),
                         tq=tq, tk=tk, interpret=True, **kw)
    _close(emu.to(torch.bfloat16).float(), want.astype(jnp.float32),
           BF16_TOL)
    want32 = j_pallas_attn(jq, jk, jv, tq=tq, tk=tk, interpret=True, **kw)
    _close(emu, want32, TOL)


def test_p_rounded_once_to_bf16_misses_the_float32_gate():
    """Why p is split: with p_hi alone the float32 output leaves
    ``rtol=1e-4``, with p_hi + p_lo it stays inside."""
    q, k, v = _inputs(300)
    kw = dict(causal=True, window=50, softcap=SOFTCAP)
    want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    assert torch.allclose(emulate_mma(q, k, v, **kw), want, **TOL)
    assert not torch.allclose(emulate_mma(q, k, v, split_p=False, **kw),
                              want, **TOL)


#: the dh 64 and 128 instances: name -> (B, S, Skv, H, kvH, dh, causal,
#: window, softcap), Pallas tiles (tq, tk) dividing S where Skv == S
WIDE_CASES = {
    "g1_dh64_causal": ((1, 300, 300, 2, 2, 64, True, 0, 0.0), (100, 60)),
    "g8_dh128_causal": ((1, 77, 77, 16, 2, 128, True, 0, 0.0), (77, 11)),
    "g3_dh72_window_softcap": ((2, 150, 150, 6, 2, 72, True, 40, 30.0),
                               (50, 30)),
    "g1_dh64_cross": ((1, 130, 301, 2, 2, 64, False, 0, 0.0), None),
}


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_emulated_mma_at_dh64_and_dh128(name):
    """The walk at the narrower instances (128-key tiles, a ragged last
    tile, G across the warpgroups' 64-row edge) within the gates of the
    plain version and, where k/v have q's length, of the Pallas kernel."""
    (B, S, Skv, H, kvH, dh, causal, window, cap), tiles = WIDE_CASES[name]
    rng = np.random.default_rng(2000 + S + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((B, S, H, dh), (B, Skv, kvH, dh),
                             (B, Skv, kvH, dh)))
    kw = dict(causal=causal, window=window, softcap=cap)
    emu = emulate_mma(q, k, v, **kw)
    _close(emu.to(torch.bfloat16).float(),
           flash_attention_ref(q, k, v, **kw).float(), BF16_TOL)
    _close(emu, flash_attention_ref(q.float(), k.float(), v.float(), **kw),
           TOL)
    if tiles is not None:
        jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
        want = j_pallas_attn(*(t.astype(jnp.bfloat16) for t in (jq, jk, jv)),
                             tq=tiles[0], tk=tiles[1], interpret=True, **kw)
        _close(emu.to(torch.bfloat16).float(), want.astype(jnp.float32),
               BF16_TOL)
