"""The port's threefry keys and draws (``repro_torch.launch.prng``) held
against ``jax.random`` on the CPU, and its sampler against
``repro.launch.sampling``.

Keys, random bits and uniforms must be equal bit for bit.  The Gumbel
transform takes two logs, which XLA and PyTorch round independently, so
Gumbel draws agree to a couple of ulps (rtol 5e-7, atol 1e-6; measured
max 9.5e-7 absolute at 151936 draws) — not bitwise.  Sampled tokens must
then be equal wherever two logits are not within that margin: measured 0
of 160 rows flipped on the mixed traces below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
from repro.launch import sampling as j_sampling

from repro_torch.launch import prng, sampling

torch.set_num_threads(1)

SEEDS = [0, 7, 2**31 + 5, 2**32 + 9]          # >= 2^31 and >= 2^32 too
POSITIONS = [0, 1, 77, 2**31 - 1, 4_000_000_000]
TINY = float(np.finfo(np.float32).tiny)


def _j_step_key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(seed), pos)


def _t_step_key(seed, pos):
    return prng.fold_in(prng.prng_key(seed)[None],
                        torch.tensor([pos], dtype=torch.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax_bitwise(seed):
    """``PRNGKey`` and ``fold_in`` give the same uint32 words."""
    np.testing.assert_array_equal(
        prng.prng_key(seed).numpy(),
        np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))
    for pos in POSITIONS:
        np.testing.assert_array_equal(
            _t_step_key(seed, pos)[0].numpy(),
            np.asarray(_j_step_key(seed, pos)).astype(np.int64))


@pytest.mark.parametrize("n", [1, 5, 256, 151936])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_match_jax_bitwise(seed, n):
    """32-bit random words and float32 uniforms on [0, 1) and on
    [tiny, 1) (the Gumbel sampler's range), for vocabulary-sized draws."""
    for pos in (0, 4_000_000_000):
        jk, tk = _j_step_key(seed, pos), _t_step_key(seed, pos)
        np.testing.assert_array_equal(
            prng.random_bits(tk, n)[0].numpy(),
            np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(
                np.int64))
        for lo in (0.0, TINY):
            mine = prng.uniform(tk, n, lo)[0].numpy()
            ref = np.asarray(jax.random.uniform(jk, (n,), jnp.float32,
                                                minval=lo))
            np.testing.assert_array_equal(mine.view(np.int32),
                                          ref.view(np.int32))


def test_gumbel_matches_jax_to_two_ulps():
    jk, tk = _j_step_key(3, 5), _t_step_key(3, 5)
    mine = prng.gumbel(tk, 151936)[0].numpy()
    ref = np.asarray(jax.random.gumbel(jk, (151936,), jnp.float32))
    np.testing.assert_allclose(mine, ref, rtol=5e-7, atol=1e-6)


def _mixed_rows(rng, n, vocab):
    """Sampler settings of ``engine_harness.random_mixed_trace`` requests
    (greedy, temperature, temperature + top-k incl. disabled values)."""
    trace = []
    while len(trace) < n:
        trace += H.random_mixed_trace(rng)
    temps = np.array([t[3] for t in trace[:n]], np.float32)
    topks = np.array([min(t[4], vocab + 7) for t in trace[:n]], np.int32)
    return temps, topks


@pytest.mark.parametrize("vocab,n", [(256, 128), (151936, 32)])
def test_sampled_tokens_equal_repro_on_mixed_trace(vocab, n):
    """Same float32 logits, seeds (some >= 2^32) and positions: the port
    samples exactly ``repro``'s tokens, greedy and sampled rows alike."""
    rng = np.random.default_rng(vocab)
    logits = (rng.normal(size=(n, vocab)) * 3).astype(np.float32)
    temps, topks = _mixed_rows(rng, n, vocab)
    assert (temps > 0).sum() > n // 4
    seeds = rng.integers(0, 2**33, n)
    pos = rng.integers(0, 5000, n).astype(np.int32)
    j_keys = jnp.stack([j_sampling.request_key(int(s)) for s in seeds])
    ref = np.asarray(j_sampling.sample_tokens(
        jnp.asarray(logits), j_sampling.step_keys(j_keys, jnp.asarray(pos)),
        jnp.asarray(temps), jnp.asarray(topks)))
    t_keys = torch.stack([sampling.request_key(int(s)) for s in seeds])
    mine = sampling.sample_tokens(
        torch.from_numpy(logits),
        sampling.step_keys(t_keys, torch.from_numpy(pos)),
        torch.from_numpy(temps), torch.from_numpy(topks)).numpy()
    np.testing.assert_array_equal(mine, ref)


def test_draws_depend_on_seed_and_position_only():
    """Placement invariance: a row's draw is the same in any batch slot."""
    keys = torch.stack([sampling.request_key(s) for s in (3, 3, 9)])
    pos = torch.tensor([10, 10, 10])
    u = prng.uniform(sampling.step_keys(keys, pos), 64)
    assert torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
