"""Per-slot token sampling for the serve engines (port of
``repro.launch.sampling``'s ``process_logits``/``sample_tokens`` and its key
derivation).

Greedy (``temperature <= 0``) is ``argmax`` and never touches a key, so it
is exact.  Sampled slots draw ``categorical`` (Gumbel-max) from keys
``fold_in(request_key(seed), position)``: the draw depends only on the
request's seed and the token position, never on the slot or the batch —
``repro``'s placement-invariance contract.  Keys, random bits and
uniforms are ``jax.random``'s threefry values bit for bit
(``launch/prng.py``), so sampled tokens equal ``repro``'s wherever the
logits do; only the Gumbel transform's ``log`` may round one ulp apart
between the frameworks.
"""
from __future__ import annotations

import torch

from . import prng

TOP_K_CAP = 64      # static top-k gather width; per-slot top_k <= cap


def request_key(seed: int) -> torch.Tensor:
    """Stable per-request key: ``PRNGKey(seed)``, (2,) int64 words."""
    return prng.prng_key(seed)


def step_keys(keys: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(S, 2) request keys + (S,) token positions -> (S, 2) step keys
    (``vmap(fold_in)``)."""
    return prng.fold_in(keys, positions)


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
    sampled = prng.categorical(keys, scaled).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)
