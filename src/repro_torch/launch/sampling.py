"""Per-slot token sampling for the serve engine (port of
``repro.launch.sampling``'s ``process_logits``/``sample_tokens`` and its key
derivation).

Greedy (``temperature <= 0``) is ``argmax`` and never touches a key, so it
is exact.  Sampled slots draw with the Gumbel-max trick from uniforms that
are a counter hash of (request key, token position, vocabulary index):
the draw depends only on the request's seed and the position, never on
the slot or the batch — ``repro``'s placement-invariance contract.  The
draws are not ``jax.random``'s threefry bits (that is queued work), so
sampled tokens agree with ``repro`` in distribution, not bitwise.
"""
from __future__ import annotations

import torch

TOP_K_CAP = 64      # static top-k gather width; per-slot top_k <= cap

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer (xor-shift-multiply) on int64 tensors."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def request_key(seed: int) -> torch.Tensor:
    """Stable per-request key: (2,) int64 words [seed >> 32, seed & M32]."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64)


def step_keys(keys: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(S, 2) request keys + (S,) token positions -> (S, 2) step keys."""
    p = _hash32(positions.to(torch.int64) + 0x9E3779B9)
    k0 = _hash32(keys[:, 0] ^ p)
    k1 = _hash32(keys[:, 1] + _hash32(p ^ k0))
    return torch.stack([k0, k1], dim=-1)


def uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, 2) step keys -> (S, n) float32 uniforms in (0, 1)."""
    i = torch.arange(n, device=keys.device, dtype=torch.int64)
    h = _hash32(_hash32(keys[:, :1] ^ i) + keys[:, 1:])
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def process_logits(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Per-slot top-k restriction: logits outside each slot's top-k set go
    to -inf.  ``top_k <= 0`` and ``top_k >= vocab_size`` disable it."""
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    kc = min(TOP_K_CAP, v)
    vals = torch.topk(logits, kc, dim=-1).values            # sorted
    idx = torch.clamp(top_k.long(), 1, kc) - 1
    kth = torch.gather(vals, 1, idx[:, None])
    use_topk = ((top_k > 0) & (top_k < v))[:, None]
    return torch.where(use_topk & (logits < kth), -torch.inf, logits)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: torch.Tensor,
                  top_k: torch.Tensor) -> torch.Tensor:
    """logits (S, V), step keys (S, 2), temperature (S,), top_k (S,) ->
    (S,) int32.  temperature <= 0 -> greedy argmax; otherwise a draw from
    softmax(top-k-masked logits / temperature)."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    masked = process_logits(logits, top_k)
    scaled = masked / torch.clamp(temperature, min=1e-6)[:, None]
    gumbel = -torch.log(-torch.log(uniforms(keys, logits.shape[-1])))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)
