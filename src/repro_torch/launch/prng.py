"""Threefry-2x32 keys and draws in torch integer ops: a port of the parts of
``jax.random`` that ``repro`` calls, bit for bit.

Words are uint32 values carried in int64 tensors and masked to 32 bits
after every add and shift (torch has no uint32 arithmetic on every
device).  What each function reproduces, from ``jax/_src/random.py`` and
``jax/_src/prng.py`` with ``jax_threefry_partitionable`` on (the installed
default) and 64-bit types off:

* ``prng_key(seed)`` — ``PRNGKey``: the words ``[0, seed mod 2^32]``
  (without 64-bit types the seed is a 32-bit value, so the high word is 0).
* ``fold_in(keys, data)`` — ``threefry_2x32(key, [0, data])``, the two
  output words as the new key.
* ``split(key, num)`` — ``_threefry_split_foldlike``: key ``i`` is the two
  output words of counter ``(0, i)``.
* ``random_bits(keys, shape)`` — 32-bit ``_random_bits``: element ``i`` of
  the row-major flattened ``shape`` hashes the 64-bit counter ``i`` as the
  word pair ``(i >> 32, i mod 2^32)`` and XORs the two output words.
* ``uniform(keys, shape, minval, maxval)`` — ``_uniform`` in float32: the
  top 23 bits as a mantissa of [1, 2), minus 1, then
  ``max(minval, f * (maxval - minval) + minval)``, the multiply-add
  rounded once as XLA contracts it into an FMA under ``jit``.
* ``normal(key, shape)`` — ``_normal_real``: a uniform on
  ``(nextafter(-1, 0), 1)`` through ``sqrt(2) * erf_inv``, with XLA's
  single-precision ``erf_inv`` polynomial (``erf_inv`` below).
* ``bernoulli(key, p, shape)`` — ``_bernoulli`` "low": ``uniform < p``.
* ``exponential(key, shape)`` — ``_exponential``: ``-log1p(-u)`` of a
  uniform on ``[0, 1)`` (``log1p`` rounds an ulp or two apart between the
  frameworks; the uniforms are bitwise).
* ``gumbel(keys, n)`` — ``_gumbel`` in its ``"low"`` mode:
  ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``.
* ``categorical(keys, logits)`` — ``argmax(gumbel + logits)``.
* ``randint(key, shape, minval, maxval)`` — ``_randint`` for int32:
  two 32-bit draws (keys split from ``key``) folded into the span as
  ``(hi % span * (2^32 % span) + lo % span) % span`` in wrapping uint32
  arithmetic.

A key is a (2,) tensor; a batch of keys (*B, 2) draws one independent
``shape`` per key, as ``jax.vmap`` over the reference's calls gives.
Draws land on the keys' device.

``offset`` (``random_bits``, ``uniform``, ``normal``, ``bernoulli``,
``exponential``) draws a chunk of a larger draw: element ``i`` of
``shape`` hashes counter ``offset + i``, so the chunks ``[o, o + n)`` of a
leaf's flattened index, drawn one by one, equal the whole-shape draw bit
for bit while holding only ``n`` counters at a time.  An int64 tensor
``offset`` of ``shape`` names each element's counter itself: a shard of
a leaf draws its elements' counters in the whole leaf (``launch.train``'s
noise pass under a mesh).
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)
# erf_inv's two polynomials (|x| small: w < 5; tails), highest power first
_ERFINV_CENTER = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    word tensors; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (2,) int64 words."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """(*B, 2) keys, integers broadcastable to (*B,) -> (*B, 2) keys
    (``fold_in`` per key; ``data`` wraps to uint32 as
    ``jnp.asarray(data, 'uint32')`` does)."""
    d = torch.as_tensor(data, device=keys.device).to(torch.int64) & M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(*B, 2) keys -> (*B, num, 2) keys (``jax.random.split`` per key,
    in one cipher pass)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def random_bits(keys: torch.Tensor, shape, *, offset: int = 0
                ) -> torch.Tensor:
    """(*B, 2) keys -> (*B, *shape) uint32 words in int64
    (``bits(key, shape)`` per key; counters from ``offset``)."""
    shape = _shape(shape)
    if torch.is_tensor(offset):
        i = offset.to(device=keys.device, dtype=torch.int64).reshape(shape)
    else:
        i = torch.arange(offset, offset + math.prod(shape),
                         dtype=torch.int64, device=keys.device).reshape(shape)
    lead = keys.shape[:-1] + (1,) * len(shape)
    y0, y1 = threefry2x32(keys[..., 0].reshape(lead),
                          keys[..., 1].reshape(lead), i >> 32, i & M32)
    return y0 ^ y1


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, *, offset: int = 0) -> torch.Tensor:
    """(*B, 2) keys -> (*B, *shape) float32 uniforms on
    ``[minval, maxval)``."""
    bits = (random_bits(keys, shape, offset=offset) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    # f * span + lo rounded once: the float64 product of two float32
    # values is exact, so one rounding to float32 at the end is the FMA
    out = (floats.to(torch.float64) * span + lo).to(torch.float32)
    return torch.clamp(out, min=lo)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (M. Giles' single-precision polynomial,
    Horner steps contracted into FMAs) — not ``torch.erfinv``, which is
    correctly rounded where XLA's polynomial is up to ~90 ulps off in the
    tails.  ``|x| == 1`` gives +-inf."""
    w = -torch.log1p(-x * x)
    center = w < 5.0
    w = torch.where(center, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    p = None
    for c_lo, c_hi in zip(_ERFINV_CENTER, _ERFINV_TAIL):
        c = torch.where(center, float(np.float32(c_lo)),
                        float(np.float32(c_hi))).to(torch.float64)
        p = c if p is None else (c + p * w).to(torch.float32).to(
            torch.float64)
    out = p.to(torch.float32) * x
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), out)


def normal(key: torch.Tensor, shape, *, offset: int = 0) -> torch.Tensor:
    """(*B, 2) keys -> (*B, *shape) float32 standard normals."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, offset=offset)
    return float(np.float32(np.sqrt(2.0))) * erf_inv(u)


def bernoulli(key: torch.Tensor, p: float, shape, *, offset: int = 0
              ) -> torch.Tensor:
    """(*B, 2) keys -> (*B, *shape) bool draws with mean ``p`` (float32
    ``p``, as a Python float is in ``jax.random.bernoulli``)."""
    return uniform(key, shape, offset=offset) < float(np.float32(p))


def exponential(key: torch.Tensor, shape, *, offset: int = 0
                ) -> torch.Tensor:
    """(*B, 2) keys -> (*B, *shape) float32 standard exponentials: ``1 - u``
    keeps ``log`` on (0, 1]."""
    return torch.log1p(uniform(key, shape, offset=offset).neg_()).neg_()


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, 2) keys -> (S, n) float32 standard Gumbel draws."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """(S, 2) keys, (S, V) float32 logits -> (S,) int64 draws (the first
    maximum on ties, as ``jnp.argmax``)."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """(2,) key -> int32 draws on ``[minval, maxval)`` of ``shape``
    (``jax.random.randint`` with int32; ``maxval <= minval`` gives
    ``minval``)."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = maxval - minval if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    off = ((hi % span) * mult & M32) + lo % span
    return ((off & M32) % span + minval).to(torch.int32)
