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

The second half is the speculative-decoding math (``launch/spec_decode.py``,
port of ``repro.launch.sampling``'s): the distribution ``sample_tokens``
draws from (``target_probs``), the leftover distribution of rejection
sampling (``residual_probs``), draws from a probability vector
(``sample_from_probs``) and the per-(request, position, stream) keys
(``spec_fold``), which fold in the *verified* token position, never the
slot or the spec step.
"""
from __future__ import annotations

import torch

from . import prng

TOP_K_CAP = 64      # static top-k gather width; per-slot top_k <= cap

# speculative sampling draws up to three times per token position; each
# stream folds its own constant on top of the (request key, position) fold,
# so no stream collides with the plain decode draw or another stream
DRAFT_STREAM = 1        # the drafter's own sampling
ACCEPT_STREAM = 2       # the accept/reject uniform
CORRECT_STREAM = 3      # the residual / bonus draw


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


def target_probs(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor) -> torch.Tensor:
    """The (S, V) distribution ``sample_tokens`` draws from: the softmax of
    the top-k-masked, temperature-scaled logits, or at temperature <= 0 the
    exact one-hot of the argmax (so greedy verification stays argmax)."""
    logits = logits.to(torch.float32)
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).to(torch.float32)
    masked = process_logits(logits, top_k)
    scaled = masked / torch.clamp(temperature, min=1e-6)[:, None]
    return torch.where((temperature > 0)[:, None],
                       torch.softmax(scaled, dim=-1), onehot)


def residual_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Leftover distribution of rejection sampling, norm(max(p - q, 0));
    ``p`` itself where the residual has no mass (p == q: a rejection has
    probability 0 and is reached only through round-off)."""
    r = torch.clamp(p - q, min=0.0)
    mass = torch.sum(r, dim=-1, keepdim=True)
    return torch.where(mass > 0, r / torch.where(mass > 0, mass, 1.0), p)


def sample_from_probs(keys: torch.Tensor, probs: torch.Tensor
                      ) -> torch.Tensor:
    """keys (S, 2), probs (S, V) -> (S,) int32 draws.  Zero-probability
    tokens are never drawn, and a one-hot row gives its index whatever the
    key."""
    logp = torch.log(torch.clamp(probs, min=0.0))
    return prng.categorical(keys, logp).to(torch.int32)


def spec_fold(keys: torch.Tensor, positions: torch.Tensor,
              stream: int) -> torch.Tensor:
    """(S, 2) request keys, (S,) or (S, J) token positions -> (S, 2) or
    (S, J, 2) keys ``fold_in(fold_in(key, position), stream)``."""
    pos = torch.as_tensor(positions, device=keys.device)
    if pos.ndim == 2:
        keys = keys[:, None].expand(*pos.shape, 2)
    return prng.fold_in(prng.fold_in(keys, pos), stream)
