"""Data generation: seeded rand, seq, sample.

Port of systemml_tpu/ops/datagen.py (lines 60-141 there): `rand` with
pdf "uniform", min, max and sparsity; `seq`; `sample`. The JAX package
draws from jax.random (threefry2x32, partitionable scheme); here the same
generator is written in torch integer ops on the tensor's own device, so
that a seeded rand() gives the JAX package's values bit for bit, in fp32
and in fp64, on the CPU and on the card alike:

- PRNGKey(seed): the key words (seed >> 32, seed & 0xFFFFFFFF) of the
  seed as a 64-bit integer;
- split: threefry of the key over the counters (0, i), i = 0, 1, each
  output pair a new key (jax/_src/prng.py `_threefry_split_foldlike`);
- bits: threefry of the key over the flattened index as (hi, lo) words
  (`iota_2x32_shape`); fp32 takes hi ^ lo, fp64 hi << 32 | lo
  (`_threefry_random_bits_partitionable`);
- uniform: the bits' top mantissa bits under the exponent of 1.0, minus
  1, scaled to [min, max), then max(min, .) (jax/_src/random.py
  `_uniform`);
- sparsity p < 1: cells where bernoulli(k2, p), i.e. uniform(k2) < p,
  is false are 0. The JAX package draws that uniform in fp64 under x64,
  the mode its tests and this port's parity tests run in; the port
  always does.

- sample without replacement: jax.random.permutation's sort shuffle
  (jax/_src/random.py `_shuffle`): ceil(3 ln n / ln(2^32 - 1)) rounds,
  each splitting the key and sorting the values stably by fresh 32-bit
  keys (1 round up to n = 1,626, 2 up to about 2.6 million, then 3);
- sample with replacement: jax.random.randint under x64 (`_randint`):
  64-bit higher and lower words from the two halves of a split, folded
  into the span by the 2^32 multiplier trick;
- seq: from + incr * i, rounded after the product and after the sum
  (XLA on the CPU does not contract this one).

The words are kept in int64 with 0xFFFFFFFF masks: torch's uint32 has
partial coverage on CUDA. A key is a pair of words: host ints, or (inside
a loop region, where a seed is a device value) a pair of 0-d int64
tensors, which `prng_key`, `split` and `fold_in` derive on the device
with no host read, as the JAX package derives a traced seed's key
(systemml_tpu/ops/datagen.py:60-66); both give the same bits. The
normal and poisson pdfs wait for ROADMAP queue 1, DNN and models (item
8).
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_seed_counter = itertools.count(1)
_global_seed = [None]   # makes unseeded rand() calls reproducible


def _waits(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it waits for "
                               f"ROADMAP queue 1, DNN and models (item 8)")


def set_global_seed(seed: Optional[int]) -> None:
    """The seed of every unseeded (or seed -1) rand() after it; None
    clears it (the JAX package's CLI -seed)."""
    global _seed_counter
    _global_seed[0] = seed
    _seed_counter = itertools.count(1)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words x1, x2 (int64
    tensors holding uint32 values) under the key (k1, k2) (host ints or
    0-d int64 tensors on x1's device), as jax/_src/prng.py
    `_threefry2x32_lowering`."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _hash_pair(key, c1, c2):
    """threefry of the counter (c1, c2) under `key`: host ints for a host
    key and host counters, else 0-d int64 tensors on the key's (or the
    counter's) device."""
    dev = next((v.device for v in (*key, c1, c2)
                if isinstance(v, torch.Tensor)), None)
    if dev is None:
        one = lambda v: torch.tensor([v], dtype=torch.int64)
        b1, b2 = threefry2x32(key[0], key[1], one(c1), one(c2))
        return int(b1), int(b2)
    word = lambda v: v if isinstance(v, torch.Tensor) else torch.full(
        (), v, dtype=torch.int64, device=dev)
    return threefry2x32(key[0], key[1], word(c1), word(c2))


def prng_key(seed):
    """jax.random.PRNGKey(seed): the seed's 64-bit words, high first; a
    0-d tensor seed (truncated to an integer) gives them as 0-d int64
    tensors on its device."""
    if isinstance(seed, torch.Tensor):
        s = seed.reshape(()).to(torch.int64)
        return (s >> 32) & _MASK, s & _MASK
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s >> 32, s & _MASK


def split(key):
    """jax.random.split(key) into two keys: threefry over the counters
    (hi 0, lo 0) and (hi 0, lo 1), in one pass of the hash."""
    dev = next((v.device for v in key if isinstance(v, torch.Tensor)), None)
    lo = torch.arange(2, dtype=torch.int64, device=dev)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    if dev is None:
        return (int(b1[0]), int(b2[0])), (int(b1[1]), int(b2[1]))
    return (b1[0], b2[0]), (b1[1], b2[1])


def fold_in(key, data):
    """jax.random.fold_in(key, data): threefry of the counter (0, data);
    data a host int or a 0-d int64 tensor."""
    return _hash_pair(key, 0, data & _MASK if isinstance(data, torch.Tensor)
                      else int(data) & _MASK)


def stream_key():
    """(base key, n) of the next unseeded rand() call: with a global seed
    the call's key is fold_in(base, n); without one, a fresh base from the
    clock. Takes n off the counter; set_stream_next gives back what a
    loop region did not draw."""
    n = next(_seed_counter)
    if _global_seed[0] is not None:
        return prng_key(_global_seed[0]), n
    return prng_key((time.time_ns() + n) % (2 ** 31)), n


def set_stream_next(n: int) -> None:
    """The counter of unseeded draws goes on at n (a loop region's exit,
    after its draws on the device)."""
    global _seed_counter
    _seed_counter = itertools.count(int(n))


def _key(seed: Optional[int]):
    """The key of a rand() call: PRNGKey(seed); for no seed or -1, a fresh
    stream per call, or with a global seed its n-th fold (the JAX
    package's `_key` without the parfor streams, which wait with parfor).
    A device seed gives a device key."""
    if isinstance(seed, torch.Tensor):
        return prng_key(seed)
    if seed is None or int(seed) == -1:
        n = next(_seed_counter)
        if _global_seed[0] is not None:
            return fold_in(prng_key(_global_seed[0]), n)
        return prng_key((time.time_ns() + n) % (2 ** 31))
    return prng_key(int(seed))


def random_bits(key: Tuple[int, int], shape: Tuple[int, int], bits: int,
                device) -> torch.Tensor:
    """threefry random bits of width 32 (int64 in [0, 2^32)) or 64 (as
    the two words (hi, lo) stacked in dim 0) over `shape`, counters the
    flattened index split into (hi, lo) words."""
    n = shape[0] * shape[1]
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    if bits == 32:
        return (b1 ^ b2).reshape(shape)
    return torch.stack([b1, b2]).reshape(2, *shape)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, e) with s = RN(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """s + e (s = RN(s + e), e its exact error, fp64) rounded to odd: the
    float toward zero from the exact value, its last bit forced to 1 when
    the sum is inexact."""
    bits = s.view(torch.int64)
    toward_zero = (e != 0) & ((e > 0) != (s > 0))
    trunc = torch.where(toward_zero, bits - 1, bits)
    return torch.where(e != 0, trunc | 1, bits).view(torch.float64)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """RN(a * b + c) in a's dtype with one rounding, as XLA on the CPU
    contracts the JAX package's `floats * (max - min) + min`. fp32: the
    product is exact in fp64, the sum rounded to odd in fp64, then to fp32
    (53 >= 24 + 2 bits). fp64: the emulated FMA of Boldo and Melquiond
    (IEEE TC 2008, Algorithm 5.4): the exact product by Dekker's split,
    a two-sum, and the low parts added with rounding to odd."""
    if a.dtype == torch.float32:
        s, e = _two_sum(a.double() * b.double(), c.double())
        return _round_odd(s, e).to(torch.float32)
    split = 134217729.0   # 2^27 + 1
    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi
    ah, al = halves(a)
    bh, bl = halves(b)
    p = a * b
    pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    return th + _round_odd(*_two_sum(tl, pe))


def uniform(key: Tuple[int, int], shape: Tuple[int, int], dtype, device,
            min_v: float = 0.0, max_v: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype, min_v, max_v) bit for bit:
    the mantissa bitcast, then (f - 1) * (max - min) + min with one
    rounding (_fma) and max(min, .), in `dtype`."""
    if dtype == torch.float32:
        bits = random_bits(key, shape, 32, device)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        hi, lo = random_bits(key, shape, 64, device)
        # (hi << 32 | lo) >> 12, kept below 2^63
        f = (((hi << 20) | (lo >> 12)) | 0x3FF0000000000000).view(
            torch.float64)
    else:
        raise TypeError(f"rand: uniform draws take fp32 or fp64, not {dtype}")
    # fills, not host copies: a loop region's graph captures the draw
    lo_v = torch.full((), min_v, dtype=dtype, device=device)
    span = torch.full((), max_v, dtype=dtype, device=device) - lo_v
    return torch.maximum(lo_v, _fma(f - 1.0, span, lo_v))


def rand(rows: int, cols: int, min_v=0.0, max_v=1.0, sparsity: float = 1.0,
         pdf: str = "uniform", seed=None, lambda_: float = 1.0, dtype=None,
         device=None, key=None) -> torch.Tensor:
    """rand(rows, cols, min, max, sparsity, pdf, seed) (reference:
    LibMatrixDatagen.generateRandomMatrix): uniform values in [min, max),
    cells dropped to 0 with probability 1 - sparsity, in the configured
    dtype on the configured device, equal to the JAX package's draw from
    the same seed. A seed of -1 or none draws a fresh stream; a 0-d
    tensor seed derives its key on its device; `key` (a loop region's
    stream) takes the place of the seed's."""
    from systemml_tpu_torch.utils.config import default_dtype, get_config

    if pdf != "uniform":
        if pdf in ("normal", "poisson"):
            raise _waits(f"rand(pdf={pdf!r})")
        raise ValueError(f"unknown pdf {pdf!r}")
    device = torch.device(get_config().device if device is None else device)
    dtype = dtype or default_dtype(device)
    k1, k2 = split(_key(seed) if key is None else key)
    shape = (int(rows), int(cols))
    if float(min_v) == float(max_v) != 0.0:
        # (f - 1) * 0 + min rounds to min whatever the bits: a dropout
        # mask's constant, with no hash of k1
        m = torch.full(shape, float(min_v), dtype=dtype, device=device)
    else:
        m = uniform(k1, shape, dtype, device, float(min_v), float(max_v))
    if float(sparsity) < 1.0:
        keep = uniform(k2, shape, torch.float64, device) < float(sparsity)
        m = torch.where(keep, m, torch.zeros((), dtype=dtype, device=device))
    return m


def _device_dtype(device, dtype):
    from systemml_tpu_torch.utils.config import default_dtype, get_config

    device = torch.device(get_config().device if device is None else device)
    return device, dtype or default_dtype(device)


def seq(from_v, to_v, incr=None, dtype=None, device=None) -> torch.Tensor:
    """seq(from, to, incr) as a column, bounds inclusive (reference:
    DataGenOp SEQ); the default increment is 1 or -1 by direction. Equal
    to the JAX package's `f + i * arange(n)` bit for bit: the arange in
    `dtype`, the product and the sum each rounded in it."""
    device, dtype = _device_dtype(device, dtype)
    f, t = float(from_v), float(to_v)
    i = (1.0 if t >= f else -1.0) if incr is None else float(incr)
    q = (t - f) / i
    n = max(int(math.floor(q)) + 1, 0) if q >= 0 else 0
    r = torch.arange(n, dtype=dtype, device=device)
    full = lambda v: torch.full((), v, dtype=dtype, device=device)
    return (full(f) + full(i) * r).reshape(-1, 1)


def _shuffle(key: Tuple[int, int], x: torch.Tensor) -> torch.Tensor:
    """jax.random.permutation(key, x) of a 1-D x: rounds of a stable sort
    by fresh 32-bit keys (held in int64, which torch sorts)."""
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_MASK)))
    for _ in range(rounds):
        key, sub = split(key)
        bits = random_bits(sub, (1, n), 32, x.device).reshape(-1)
        x = x[torch.sort(bits, stable=True).indices]
    return x


def _randint(key: Tuple[int, int], size: int, lo: int, hi: int,
             device) -> torch.Tensor:
    """jax.random.randint(key, (size,), lo, hi) under x64: higher and
    lower 64-bit words from the two halves of a split, offset =
    (higher % span * (2^32 % span)^2 % span + lower % span) % span. Each
    word w = hi * 2^32 + lo is reduced as (hi % s * 2^32 % s + lo % s),
    exact in int64 for a span below 2^31."""
    span = max(int(hi) - int(lo), 1)
    if span >= 1 << 31:
        raise ValueError(f"sample: a range of {span} values is past the "
                         f"exact int64 reduction (2^31)")
    k1, k2 = split(key)
    m32 = (1 << 32) % span

    def word_mod(k):
        w = random_bits(k, (1, size), 64, device).reshape(2, -1)
        return ((w[0] % span) * m32 + w[1] % span) % span

    mult = (m32 * m32) % span
    off = (word_mod(k1) * mult + word_mod(k2)) % span
    return int(lo) + off


def sample(range_max: int, size: int, replace: bool = False,
           seed: Optional[int] = None, dtype=None,
           device=None) -> torch.Tensor:
    """sample(range, size, replace, seed): `size` values from 1..range as
    a column (reference: DataGenOp SAMPLE), equal to the JAX package's
    draw bit for bit, on the CPU and on the card."""
    device, dtype = _device_dtype(device, dtype)
    k = _key(seed)
    n, s = int(range_max), int(size)
    if replace:
        vals = _randint(k, s, 1, n + 1, device)
    else:
        vals = _shuffle(k, torch.arange(n, dtype=torch.int64,
                                        device=device))[:s] + 1
    return vals.to(dtype).reshape(-1, 1)
