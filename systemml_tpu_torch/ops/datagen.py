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
(systemml_tpu/ops/datagen.py:60-66); both give the same bits.
- normal: jax.random.normal's sqrt(2) * erf_inv(u) over u uniform in
  [nextafter(-1, 0), 1), with erf_inv (and the log1p and log inside it)
  written out as XLA on the CPU evaluates them (`erf_inv`): fp32 bit for
  bit; fp64 within the bound tests/test_torch_datagen.py states, since
  XLA calls libm's log there. The poisson pdf waits for ROADMAP queue 1,
  item 8b.

A parfor iteration draws its unseeded rand() calls from a sub-stream of
its own (`stream_scope`, systemml_tpu/ops/datagen.py:30-46): with a
global seed the key of its n-th draw is fold_in(fold_in(PRNGKey(seed),
iteration id), n), whichever worker, stream or mode runs the iteration.
The sub-stream is a contextvars.ContextVar, so each worker thread sees
its own iteration's.
"""

from __future__ import annotations

import contextvars
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
# the parfor iteration's sub-stream: {"id": iteration id, "n": counter}
_stream = contextvars.ContextVar("rand_stream", default=None)


def _waits(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it waits for "
                               f"ROADMAP queue 1, the poisson pdf and "
                               f"double-float operands (item 8b)")


def set_global_seed(seed: Optional[int]) -> None:
    """The seed of every unseeded (or seed -1) rand() after it; None
    clears it (the JAX package's CLI -seed)."""
    global _seed_counter
    _global_seed[0] = seed
    _seed_counter = itertools.count(1)


def stream_scope(stream_id: int):
    """Enters the deterministic sub-stream of parfor iteration
    `stream_id`; returns the token for reset_stream."""
    return _stream.set({"id": int(stream_id), "n": itertools.count(1)})


def reset_stream(token) -> None:
    _stream.reset(token)


def _next_draw():
    """(n, sub-stream or None) of the next unseeded draw."""
    st = _stream.get()
    return (next(st["n"]) if st is not None else next(_seed_counter)), st


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
    n, st = _next_draw()
    if _global_seed[0] is not None:
        base = prng_key(_global_seed[0])
        if st is not None:
            base = fold_in(base, st["id"])
        return base, n
    return prng_key((time.time_ns() + n + (st["id"] << 20 if st else 0))
                    % (2 ** 31)), n


def set_stream_next(n: int) -> None:
    """The counter of unseeded draws goes on at n (a loop region's exit,
    after its draws on the device); inside a parfor iteration, its
    sub-stream's."""
    global _seed_counter
    st = _stream.get()
    if st is not None:
        st["n"] = itertools.count(int(n))
        return
    _seed_counter = itertools.count(int(n))


def _key(seed: Optional[int]):
    """The key of a rand() call: PRNGKey(seed); for no seed or -1, a fresh
    stream per call, or with a global seed its n-th fold, in a parfor
    iteration from the iteration's sub-stream (the JAX package's `_key`).
    A device seed gives a device key."""
    if isinstance(seed, torch.Tensor):
        return prng_key(seed)
    if seed is None or int(seed) == -1:
        base, n = stream_key()
        # without a global seed the base is already fresh per call
        return fold_in(base, n) if _global_seed[0] is not None else base
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


# --------------------------------------------------------------------------
# pdf="normal": jax.random.normal's sqrt(2) * erf_inv(uniform(nextafter(-1,
# 0), 1)), with erf_inv as XLA on the CPU evaluates it. Only basic IEEE ops
# (and _fma, itself exact) are composed, each its own torch kernel, so the
# card gives the CPU's bits.
# --------------------------------------------------------------------------

# XLA's ErfInv32: Giles' polynomials, w < 5 and w >= 5 (highest degree first)
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682))
# XLA's ErfInv64: w < 6.25 (23 terms), w < 16 (19), w >= 16 (17)
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267370e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))
# XLA's EmitLog1p for |x| < sqrt(2) - 1: a Cephes rational
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# XLA:CPU's vectorized fp32 log (Cephes; polynomial_approximations.cc)
_LOG32_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
            -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
            2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
# fdlibm's minimax R(s^2) of 2 atanh(s) - 2s, over s = (m - 1) / (m + 1)
_LG = (6.666666666666735130e-01, 3.999999999940941908e-01,
       2.857142874366239149e-01, 2.222219843214978396e-01,
       1.818357216161805012e-01, 1.531383769920937332e-01,
       1.479819860511658591e-01)
_LN2_HI, _LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10


def _const(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _horner(x: torch.Tensor, coeffs, start=None) -> torch.Tensor:
    """sum c_i x^(n-i) by Horner's rule with each step one FMA, as XLA on
    the CPU contracts `p * x + c`."""
    p = _const(coeffs[0], x) if start is None else start
    for c in coeffs[1:]:
        p = _fma(p, x, _const(c, x))
    return p


def _log32(x: torch.Tensor) -> torch.Tensor:
    """log of a positive normal fp32 x as XLA:CPU's Cephes approximation,
    its multiply-adds contracted as LLVM contracts them."""
    one = _const(1.0, x)
    t = torch.maximum(x, _const(1.1754943508222875e-38, x))
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 0x7f).to(torch.float32) + one
    m = ((bits & ~0x7f800000) | 0x3f000000).view(torch.float32)
    small = m < 0.707106781186547524
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    t1 = torch.where(small, m, zero)
    e = e - torch.where(small, one, zero)
    m = (m - one) + t1
    x2 = m * m
    x3 = x2 * m
    c = [_const(v, x) for v in _LOG32_P]
    y = _fma(_fma(m, c[0], c[1]), m, c[2])
    y1 = _fma(_fma(m, c[3], c[4]), m, c[5])
    y2 = _fma(_fma(m, c[6], c[7]), m, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _const(-2.12194440e-4, x) * e)
    m = _fma(_const(-0.5, x), x2, m) + y
    return _fma(_const(0.693359375, x), e, m)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e) with p = RN(a * b) and p + e = a * b exactly (Dekker)."""
    def halves(v):
        t = 134217729.0 * v
        hi = t - (t - v)
        return hi, v - hi
    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _log64(x: torch.Tensor) -> torch.Tensor:
    """log of a positive normal fp64 x, near correct rounding: x = 2^k m
    with m in [sqrt(2)/2, sqrt(2)], log m = 2 atanh(s) for s = (m-1)/(m+1)
    carried in double-double, plus k ln 2. XLA on the CPU calls libm's
    log; this agrees with it but for about 0.1-0.4% of arguments, each
    one ulp apart (tests/test_torch_datagen.py holds the bound)."""
    bits = x.view(torch.int64)
    k = ((bits >> 52) & 0x7ff) - 1023
    m = ((bits & 0x000FFFFFFFFFFFFF) | 0x3FF0000000000000).view(
        torch.float64)
    big = m > 1.4142135623730951
    m = torch.where(big, m * 0.5, m)
    dk = (k + big.to(torch.int64)).to(torch.float64)
    f = m - 1.0
    d_hi, d_lo = _two_sum(m, torch.ones_like(m))
    s = f / d_hi
    p, pe = _two_prod(s, d_hi)
    s_lo = (((f - p) - pe) - s * d_lo) / d_hi
    z = s * s
    w = z * z
    r = (z * (_LG[0] + w * (_LG[2] + w * (_LG[4] + w * _LG[6])))
         + w * (_LG[1] + w * (_LG[3] + w * _LG[5])))
    hi, e = _two_sum(dk * _LN2_HI, 2.0 * s)
    return hi + (((e + 2.0 * s_lo) + s * r) + dk * _LN2_LO)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a positive x, as XLA and CUDA
    give it (torch.sqrt on the CPU may be an ulp off): torch.sqrt, then
    the neighbour whose square brackets x. fp32 squares the midpoints
    exactly in fp64; fp64 compares x - s^2, formed exactly by _two_prod,
    with the half-ulp gap s * ulp + ulp^2 / 4."""
    s = torch.sqrt(x)
    inf = _const(float("inf"), x)
    up, dn = torch.nextafter(s, inf), torch.nextafter(s, -inf)
    if x.dtype == torch.float32:
        xd, sd = x.double(), s.double()
        hi = (sd + up.double()) * 0.5
        lo = (sd + dn.double()) * 0.5
        return torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, dn, s))
    p, e = _two_prod(s, s)
    r = (x - p) - e
    gap_up = _two_prod(s, up - s)[0] + 0.25 * (up - s) * (up - s)
    gap_dn = _two_prod(s, s - dn)[0] - 0.25 * (s - dn) * (s - dn)
    return torch.where(r > gap_up, up, torch.where(-r > gap_dn, dn, s))


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's EmitLog1p: the Cephes rational below sqrt(2) - 1 in |x|,
    log(x + 1) above it."""
    log = _log32 if x.dtype == torch.float32 else _log64
    large = log(x + 1.0)
    x2 = x * x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ratio = (_horner(x, (0.0,) + _LOG1P_NUM, zero)
             / _horner(x, (0.0,) + _LOG1P_DEN, zero))
    small = x + _fma(_const(-0.5, x), x2, (x * x2) * ratio)
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 of fp32 or fp64 x in (-1, 1) as XLA's ErfInv32 / ErfInv64
    (torch.erfinv gives other bits): w = -log1p(-x^2), a polynomial in
    w - 2.5 or sqrt(w) - 3 (fp32), in w - 3.125, sqrt(w) - 3.25 or
    sqrt(w) - 5 (fp64), times x; +-1 gives +-inf."""
    w = -_log1p(-x * x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        v = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
        coef = lambda i: torch.where(lt, _const(_ERFINV32[0][i], x),
                                     _const(_ERFINV32[1][i], x))
        p = coef(0)
        for i in range(1, 9):
            p = _fma(p, v, coef(i))
    else:
        lt6, lt16 = w < 6.25, w < 16.0
        a, b, c = _ERFINV64
        v = torch.where(lt6, w - 3.125, _sqrt(w) - torch.where(
            lt16, _const(3.25, x), _const(5.0, x)))

        def coef(i):
            r = _const(a[i], x)
            if i < 19:
                r = torch.where(lt6, r, _const(b[i], x))
            if i < 17:
                r = torch.where(lt16, r, _const(c[i], x))
            return r

        p = coef(0)
        for i in range(1, 17):
            p = _fma(p, v, coef(i))
        for i in range(17, 19):
            p = torch.where(lt16, _fma(p, v, coef(i)), p)
        for i in range(19, 23):
            p = torch.where(lt6, _fma(p, v, coef(i)), p)
    inf = _const(float("inf"), x)
    return torch.where(x.abs() == 1.0, x * inf, p * x)


def normal(key: Tuple[int, int], shape: Tuple[int, int], dtype,
           device) -> torch.Tensor:
    """jax.random.normal(key, shape, dtype): sqrt(2) * erf_inv(u), u
    uniform in [nextafter(-1, 0), 1)."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_dt(-1.0), np_dt(0.0)))
    u = uniform(key, shape, dtype, device, lo, 1.0)
    sqrt2 = float(np_dt(np.sqrt(2.0)))
    return torch.full((), sqrt2, dtype=dtype, device=device) * erf_inv(u)


def rand(rows: int, cols: int, min_v=0.0, max_v=1.0, sparsity: float = 1.0,
         pdf: str = "uniform", seed=None, lambda_: float = 1.0, dtype=None,
         device=None, key=None) -> torch.Tensor:
    """rand(rows, cols, min, max, sparsity, pdf, seed) (reference:
    LibMatrixDatagen.generateRandomMatrix): uniform values in [min, max)
    or standard normal ones, cells dropped to 0 with probability 1 -
    sparsity, in the configured dtype on the configured device, equal to
    the JAX package's draw from the same seed. A seed of -1 or none draws
    a fresh stream; a 0-d tensor seed derives its key on its device;
    `key` (a loop region's stream) takes the place of the seed's."""
    from systemml_tpu_torch.utils.config import default_dtype, get_config

    if pdf not in ("uniform", "normal"):
        if pdf == "poisson":
            raise _waits(f"rand(pdf={pdf!r})")
        raise ValueError(f"unknown pdf {pdf!r}")
    device = torch.device(get_config().device if device is None else device)
    dtype = dtype or default_dtype(device)
    k1, k2 = split(_key(seed) if key is None else key)
    shape = (int(rows), int(cols))
    if pdf == "normal":
        m = normal(k1, shape, dtype, device)
    elif float(min_v) == float(max_v) != 0.0:
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
