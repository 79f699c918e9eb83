"""Deterministic synthetic token pipeline (port of ``repro.data.synthetic``).

A stateless index->batch function: batch ``i`` is a pure function of
(seed, i), so restarts resume mid-epoch exactly.  The "task" is learnable
structure (a noisy Markov chain over the vocab) so smoke training shows a
real loss decrease.  Draws use the port's threefry (``launch/prng.py``):
the same keys, start tokens and Gumbel noise as ``jax.random``, so batches
equal the reference's except where a Gumbel draw's logs round an ulp apart
at a near-tie of two transitions.  The transition table is vocab x vocab
float32 (``np.random.default_rng(seed)``), so it fits only at reduced
vocab sizes, as the reference's train CLI always runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..launch import prng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_skew: float = 4.0      # higher -> more learnable structure


def _transition_logits(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    return rng.normal(size=(cfg.vocab_size, cfg.vocab_size)) \
        * cfg.markov_skew


def make_batch_fn(cfg: DataConfig, device=None):
    """Returns batch_fn(step) -> {"tokens", "labels"} (B, S) int32 on
    ``device`` (the GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    logits = torch.from_numpy(_transition_logits(cfg).astype(
        np.float32)).to(dev)
    base = prng.prng_key(cfg.seed).to(dev)

    def batch_fn(step) -> dict:
        key = prng.fold_in(base, int(step))
        k0, kseq = prng.split(key)
        tok = prng.randint(k0, (cfg.global_batch,), 0, cfg.vocab_size)
        seq = [tok]
        for k in prng.split(kseq, cfg.seq_len):
            # categorical(k, logits[tok]): one key, a (B, V) Gumbel draw
            row = logits[tok.long()]
            tok = torch.argmax(prng.gumbel(k, row.shape) + row,
                               dim=-1).to(torch.int32)
            seq.append(tok)
        seq = torch.stack(seq, dim=1)                         # (B, S+1)
        return {"tokens": seq[:, :-1].contiguous(),
                "labels": seq[:, 1:].contiguous()}

    return batch_fn


def host_batch(cfg: DataConfig, step: int) -> dict:
    """Host-side numpy twin (the batch drawn on the CPU)."""
    return {k: v.numpy() for k, v in
            make_batch_fn(cfg, device="cpu")(step).items()}
