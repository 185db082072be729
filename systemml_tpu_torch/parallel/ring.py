"""Scaled dot-product attention on one device.

Port of the single-device reference of systemml_tpu/parallel/ring.py
(`attention`, lines 45-63 there): scores in true fp32 (or fp64), the
causal mask to -inf, a row softmax, the weighted sum. The JAX package has
no Pallas kernel here; ring and Ulysses attention over a mesh wait for
ROADMAP queue 1, distributed and elastic (item 12).

Shape convention: [H, T, d] (heads, sequence, head dim); a 2-D [T, d]
input is one head.
"""

from __future__ import annotations

import math

import torch


def _with_heads(x: torch.Tensor):
    return (x.unsqueeze(0), True) if x.dim() == 2 else (x, False)


def attention(q, k, v, causal: bool = False, scale=None):
    """softmax(q k^T * scale [masked]) v over the last two dims; `scale`
    defaults to 1 / sqrt(d)."""
    q, squeeze = _with_heads(q)
    k, _ = _with_heads(k)
    v, _ = _with_heads(v)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(tq, device=s.device)[:, None]
                >= torch.arange(tk, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full((), float("-inf"),
                                            dtype=s.dtype, device=s.device))
    out = torch.matmul(torch.softmax(s, dim=-1), v)
    return out[0] if squeeze else out
