"""JAX's default PRNG on torch tensors: threefry2x32 in partitionable mode,
and ``normal`` as JAX 0.9 computes it on the CPU.

The JAX package draws every initial weight with ``jax.random``; the port
draws the same numbers from the same seed, on any device, without JAX.
Read from ``jax/_src/prng.py`` and ``jax/_src/random.py`` of JAX 0.9.0
(``jax_threefry_partitionable=True``, ``jax_default_prng_impl=
threefry2x32``):

* ``key(seed)`` is ``PRNGKey(seed)``: the seed's high and low 32 bits
  (``_threefry_seed``);
* ``split(key, n)`` is ``_threefry_split_foldlike``: threefry of the
  64-bit counters 0..n-1 (high word, low word) under the key, the two
  output words being the new key;
* ``_bits(key, start, stop)`` is ``_threefry_random_bits_partitionable``
  for 32 bits at the flat indices start..stop-1: threefry of each index as
  a 64-bit counter, and the two output words XORed;
* ``normal(key, shape)`` is ``_normal_real``: the bits' top 23 bits as the
  mantissa of a float in [1, 2), minus 1, scaled onto
  [nextafter(-1, 0), 1), then ``sqrt(2) * erf_inv``;
* ``randint(key, shape, minval, maxval)`` is ``_randint`` for int32: the
  key split in two, 32 bits drawn under each, and the pair reduced modulo
  the span through the multiplier ``2**32 mod span``, in uint32
  arithmetic that wraps.

The 32-bit words live in int64 tensors and are masked after every add and
shift (torch has few uint32 operations). The bits are exact. ``erf_inv``
is XLA's single-precision polynomial (the chlo lowering), over XLA's CPU
``log1p`` (a Cephes rational below sqrt(2) - 1, a Cephes ``log`` of
``1 + x`` above), with XLA's fused multiply-adds where its CPU code
contracts them; each fused multiply-add is formed in float64 and rounded
once to float32, which is exact unless the float64 sum itself rounds onto
a float32 rounding midpoint. Measured against ``jax.random.normal`` on the
CPU: see ROADMAP C7. Every operation is elementwise IEEE arithmetic, so the
card and the CPU draw the same bits.

A key on the ``meta`` device draws shapes only: ``split``, ``normal`` and
``randint`` return meta tensors of their shapes and dtypes without running
threefry, so that an ``init`` on ``device="meta"`` (the step builders'
abstract parameters) returns its tree leaf for leaf at no cost.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements per chunk of a draw: bounds the int64 temporaries (~1 GB)
_CHUNK = 1 << 24

# XLA's ErfInv32 (chlo_legalize_to_hlo), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU log1p below sqrt(2) - 1: Cephes' rational, highest degree first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# XLA's CPU logf (Cephes/Eigen), highest degree first
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def key(seed: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor of uint32 words.
    JAX (without x64) takes the seed as a 32-bit integer: its high word is
    0 and its low word the seed's two's complement."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in 32 signed bits, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64,
                        device=torch.device(device))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2); all int64 tensors holding uint32 values, broadcast
    together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _counters(start: int, stop: int, device: torch.device):
    """``iota_2x32_shape``: flat indices start..stop-1 as (high, low)
    32-bit words."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys on ``key``'s device."""
    if key.is_meta:
        return key.new_empty((num, 2))
    hi, lo = _counters(0, num, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def _bits(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    hi, lo = _counters(start, stop, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def _c(v) -> object:
    """A tensor in float64, or a constant rounded to float32 first."""
    return v.double() if isinstance(v, torch.Tensor) else float(np.float32(v))


def _fma(a, b, c) -> torch.Tensor:
    """fp32 fused multiply-add ``a * b + c``, rounded once: the product of
    two floats is exact in float64."""
    return (_c(a) * _c(b) + _c(c)).float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, c)
    return p


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``logf`` for x > 0: Cephes' polynomial on the mantissa in
    [sqrt(1/2), sqrt(2)), with XLA's operation order and contractions."""
    x = torch.clamp_min(x, float(np.float32(2.0 ** -126)))
    bits = x.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < float(np.float32(0.707106781186547524))
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    c = _LOG_P
    y = _fma(t, c[0], c[1])
    y1 = _fma(t, c[3], c[4])
    y2 = _fma(t, c[6], c[7])
    y = _fma(y, t, c[2])
    y1 = _fma(y1, t, c[5])
    y2 = _fma(y2, t, c[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * float(np.float32(-2.12194440e-4)))
    t = _fma(-0.5, x2, t)
    t = t + y
    return _fma(0.693359375, e, t)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log1p`` for float32 x > -1."""
    x2 = x * x
    q = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(-0.5, x2, (x * x2) * q)
    return torch.where(x.abs() < float(np.float32(0.41421356237309504880)),
                       small, _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``erf_inv`` (``ErfInv32``) for float32 x in
    [-1, 1]."""
    w = -log1p(x * -x)
    lt = w < 5.0
    # float64 then float32: a correctly rounded square root (torch's float32
    # sqrt on the CPU is not always)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, c_lt, c_ge))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_flat(bits: torch.Tensor) -> torch.Tensor:
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    span = float(np.float32(1.0) - np.float32(lo))
    u = torch.clamp_min(floats * span + lo, lo)
    return erf_inv(u) * float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``key``'s device, drawn
    in chunks of the flat index so a large draw keeps its temporaries
    bounded."""
    shape = tuple(int(s) for s in shape)
    if key.is_meta:
        return torch.empty(shape, dtype=torch.float32, device=key.device)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for start in range(0, n, _CHUNK):
        stop = min(start + _CHUNK, n)
        out[start:stop] = _normal_flat(_bits(key, start, stop))
    return out.reshape(shape)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) as int32 values, two's complement."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) on
    ``key``'s device, bit for bit: JAX 0.9's ``_randint``. The span is
    ``maxval - minval`` as uint32 (1 when ``maxval <= minval``);
    ``(hi % span) * (2**32 % span) + lo % span``, each step wrapping to 32
    bits, modulo the span, is added to ``minval``. Bounds outside int32
    raise, as JAX's do."""
    shape = tuple(int(s) for s in shape)
    minval, maxval = int(minval), int(maxval)
    if not all(-2 ** 31 <= v < 2 ** 31 for v in (minval, maxval)):
        raise ValueError(f"randint bounds must fit in int32, got "
                         f"[{minval}, {maxval})")
    if key.is_meta:
        return torch.empty(shape, dtype=torch.int32, device=key.device)
    n = math.prod(shape)
    k1, k2 = split(key)
    higher, lower = _bits(k1, 0, n), _bits(k2, 0, n)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    offset = ((higher % span) * mult) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return _int32((offset + (minval & _MASK)) & _MASK).reshape(shape)
