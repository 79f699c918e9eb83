"""Threefry-2x32 keys and draws in torch integer ops: a port of the parts of
``jax.random`` that ``repro.launch.sampling`` calls, bit for bit.

Words are uint32 values carried in int64 tensors and masked to 32 bits
after every add and shift (torch has no uint32 arithmetic on every
device).  What each function reproduces, from ``jax/_src/random.py`` and
``jax/_src/prng.py`` with ``jax_threefry_partitionable`` on (the default)
and 64-bit types off:

* ``prng_key(seed)`` — ``PRNGKey``: the words ``[0, seed mod 2^32]``
  (without 64-bit types the seed is a 32-bit value, so the high word is 0).
* ``fold_in(keys, data)`` — ``threefry_2x32(key, [0, data])``, the two
  output words as the new key.
* ``random_bits(keys, n)`` — 32-bit ``_random_bits``: element ``i`` hashes
  the 64-bit counter ``i`` as the word pair ``(0, i)`` and XORs the two
  output words.
* ``uniform(keys, n, minval)`` — ``_uniform`` in float32: the top 23 bits
  as a mantissa of [1, 2), minus 1, scaled into ``[minval, 1)``.
* ``gumbel(keys, n)`` — ``_gumbel`` in its ``"low"`` mode:
  ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``.
* ``categorical(keys, logits)`` — ``argmax(gumbel + logits)``.

Every function takes a batch of keys (S, 2), one per row, as
``jax.vmap`` over the reference's calls gives.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


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


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(S, 2) keys, (S,) integers -> (S, 2) keys (``fold_in`` per row;
    ``data`` wraps to uint32 as ``jnp.asarray(data, 'uint32')`` does)."""
    d = data.to(torch.int64) & M32
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, 2) keys -> (S, n) uint32 words in int64 (``bits(key, (n,))``)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """(S, 2) keys -> (S, n) float32 uniforms on ``[minval, 1)``."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    span = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(
        minval, dtype=torch.float32)
    return torch.clamp(floats * span.to(keys.device) + minval, min=minval)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, 2) keys -> (S, n) float32 standard Gumbel draws."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """(S, 2) keys, (S, V) float32 logits -> (S,) int64 draws (the first
    maximum on ties, as ``jnp.argmax``)."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
