"""The port's full ``NLDPEConfig`` (``core/engine.py``) held against
``repro``'s: every ablation switch, ``bits`` and ``logdomain`` reach the
model's logits as they do in ``repro``; the ``softmax`` and ``dmmul``
dispatchers, ``nldpe_softmax`` and ``in_domain`` tables equal
``repro``'s; and the engines serve ``ON`` numerics with ``repro``'s
tokens.

Float32 activations throughout (at bf16 a one-ulp difference moves an
8-bit code about one time in twelve, ROADMAP.md C): logits within 1e-5,
the tolerance of tests/test_torch_model.py (f32 sums in another order,
``exp`` ulps; measured 4e-7).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
from repro.core import acam as j_acam
from repro.core import logdomain as j_logdomain
from repro.core.engine import NLDPEConfig as JNLDPEConfig
from repro.kernels.dual_compute.ops import (
    fused_linear_acam as j_fused_linear_acam)
from repro.launch.engine import PagedServeEngine as JPagedServeEngine
from repro.launch.engine import ServeEngine as JServeEngine
from repro.models import lm as j_lm

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core import acam, logdomain
from repro_torch.core.engine import FUSED, NLDPEConfig, OFF, ON
from repro_torch.kernels.dual_compute.ops import fused_linear_acam
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.launch.kvpool import nldpe_fingerprint
from repro_torch.models import lm

torch.set_num_threads(1)

CFG32 = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                            activation_dtype=torch.float32)
J_CFG32 = dataclasses.replace(H.CFG, activation_dtype=jnp.float32)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
B, C, MAX_LEN, PAGE, PAGES = 2, 6, 16, 4, 9

# each switch alone off an ON (or FUSED) config, the activation tables at
# 6 bits, and other log-domain grids: (port kwargs, repro kwargs)
_LD = dict(score_range=6.0)
VARIANTS = {
    "acam_activations_off": dict(enabled=True, acam_activations=False),
    "logdomain_dmmul_off": dict(enabled=True, logdomain_dmmul=False),
    "acam_softmax_off": dict(enabled=True, acam_softmax=False),
    "fused_acam_activations_off": dict(enabled=True, fused_dual_compute=True,
                                       acam_activations=False),
    "bits6": dict(enabled=True, bits=6),
    "fused_bits6": dict(enabled=True, fused_dual_compute=True, bits=6),
    "logdomain_range6": dict(enabled=True, logdomain="range6"),
}


def _configs(name):
    kw = VARIANTS[name]
    mine, ref = dict(kw), dict(kw)
    if kw.get("logdomain") == "range6":
        mine["logdomain"] = logdomain.LogDomainConfig(**_LD)
        ref["logdomain"] = j_logdomain.LogDomainConfig(**_LD)
    return NLDPEConfig(**mine), JNLDPEConfig(**ref)


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG32.vocab_size, (B, C)).astype(np.int32)
    base = np.array([0, 5], np.int32)             # slot 1 starts mid-page
    positions = base[:, None] + np.arange(C, dtype=np.int32)
    bt = np.array([[3, 1, 8, PAGES], [0, 6, 2, 4]], np.int32)
    nxt = rng.integers(0, CFG32.vocab_size, (B,)).astype(np.int32)
    return tokens, positions, bt, nxt


def _repro_logits(nldpe):
    """A chunk into a paged cache (slot 1's prefix [0, 5) cached), then a
    decode step: ``repro``'s jitted forward."""
    tokens, positions, bt, nxt = _inputs()
    cache = j_lm.init_model_cache(J_CFG32, B, MAX_LEN, dtype=jnp.float32,
                                  paged=(PAGES, PAGE))
    att = cache["groups"]["b0"]["attn"]
    att["bt"] = jnp.broadcast_to(jnp.asarray(bt), att["bt"].shape)
    pos = np.full((B, MAX_LEN), -1, np.int32)
    pos[1, :5] = np.arange(5)
    att["pos"] = jnp.broadcast_to(jnp.asarray(pos), att["pos"].shape)
    mask = jnp.ones((B,), bool)
    fwd = jax.jit(partial(j_lm.forward, cfg=J_CFG32, mode="chunk",
                          nldpe=nldpe))
    lg1, cache = fwd(H.shared_params(), jnp.asarray(tokens), cache=cache,
                     positions=jnp.asarray(positions), write_mask=mask)
    step = jax.jit(partial(j_lm.decode_step, cfg=J_CFG32, nldpe=nldpe))
    lg2, _ = step(H.shared_params(), token=jnp.asarray(nxt),
                  pos=jnp.asarray(positions[:, -1] + 1), cache=cache,
                  write_mask=mask)
    return np.asarray(lg1), np.asarray(lg2)


def _port_logits(nldpe):
    tokens, positions, bt, nxt = _inputs()
    p = lm.serving_params(from_jax(H.shared_params(), device="cpu"), CFG32,
                          nldpe)
    cache = lm.init_model_cache(CFG32, B, MAX_LEN, paged=(PAGES, PAGE),
                                device="cpu")
    cache["bt"].copy_(torch.from_numpy(bt))
    cache["pos"][1, :5] = torch.arange(5, dtype=torch.int32)
    mask = torch.ones((B,), dtype=torch.bool)
    lg1 = lm.forward(p, torch.from_numpy(tokens), CFG32, cache=cache,
                     positions=torch.from_numpy(positions), nldpe=nldpe,
                     write_mask=mask)
    lg2 = lm.decode_step(p, CFG32, torch.from_numpy(nxt),
                         torch.from_numpy(positions[:, -1] + 1), cache,
                         nldpe=nldpe, write_mask=mask)
    return lg1.numpy(), lg2.numpy()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_switch_logits_match_repro(name):
    """Each switch changes the logits (against ``ON``/``FUSED``), and the
    port's logits are ``repro``'s within F32_TOL with the same argmax."""
    mine_cfg, ref_cfg = _configs(name)
    mine, ref = _port_logits(mine_cfg), _repro_logits(ref_cfg)
    for m, r in zip(mine, ref):
        assert np.isfinite(m).all()
        np.testing.assert_allclose(m, r, **F32_TOL)
        np.testing.assert_array_equal(m.argmax(-1), r.argmax(-1))
    if name != "acam_softmax_off":         # no model op calls softmax
        full = FUSED if mine_cfg.fused_dual_compute else ON
        assert not np.array_equal(mine[0], _port_logits(full)[0])


@pytest.mark.parametrize("cfg", ["OFF", "ON", "ON_no_softmax",
                                 "ON_no_dmmul"])
def test_softmax_and_dmmul_dispatchers_match_repro(cfg):
    """``softmax`` (over the last and a middle axis) and ``dmmul`` on the
    same inputs: the softmax within 1e-6 (``exp`` ulps on [0, 1]); the
    DMMul within F32_TOL (nine float32 products of grid values, about 1
    each, summed in another order: 9 u sum|ab| ~ 1e-5)."""
    kw = {"OFF": {}, "ON": dict(enabled=True),
          "ON_no_softmax": dict(enabled=True, acam_softmax=False),
          "ON_no_dmmul": dict(enabled=True, logdomain_dmmul=False)}[cfg]
    mine, ref = NLDPEConfig(**kw), JNLDPEConfig(**kw)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32) * 4
    a = rng.normal(size=(4, 9)).astype(np.float32)
    b = rng.normal(size=(9, 6)).astype(np.float32)
    for axis in (-1, 1):
        np.testing.assert_allclose(
            mine.softmax(torch.from_numpy(x), axis=axis).numpy(),
            np.asarray(jax.jit(partial(ref.softmax, axis=axis))(
                jnp.asarray(x))),
            rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        mine.dmmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax.jit(ref.dmmul)(jnp.asarray(a), jnp.asarray(b))),
        **F32_TOL)


def test_nldpe_softmax_matches_repro():
    """Fig 6b's five steps: every output on the [0, 1] 8-bit grid, equal
    to ``repro``'s (bitwise codes; values within 1e-6 for ``exp``)."""
    rng = np.random.default_rng(2)
    y = rng.normal(size=(4, 33)).astype(np.float32) * 5
    y[0, :3] = -1e30                               # beyond the score range
    for cfg in (logdomain.DEFAULT_CFG,
                logdomain.LogDomainConfig(bits=6, **_LD)):
        jcfg = j_logdomain.LogDomainConfig(bits=cfg.bits,
                                           score_range=cfg.score_range)
        mine = logdomain.nldpe_softmax(torch.from_numpy(y), cfg).numpy()
        ref = np.asarray(jax.jit(partial(j_logdomain.nldpe_softmax,
                                         cfg=jcfg))(jnp.asarray(y)))
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)
        step = 1.0 / ((1 << cfg.bits) - 1)
        np.testing.assert_array_equal(np.round(mine / step),
                                      np.round(ref / step))


@pytest.mark.parametrize("in_domain", [None, (-1.5, 2.5)])
def test_tables_with_in_domain_match_repro(in_domain):
    """``get_table(name, bits, encoding, in_domain)``: thresholds,
    rows per bit and the output grid bitwise ``repro``'s, one table per
    key; ``acam_activation`` over that domain equal to ``repro``'s; and
    kernel B's plain version (``fused_linear_acam``) with it within 1e-6 of
    ``repro``'s interpret-mode kernel (one ACAM step where the float32
    pre-activation sums round across a breakpoint is not allowed: none
    does at this shape)."""
    for bits, enc in ((8, "gray"), (6, "binary")):
        mine = acam.get_table("silu", bits, enc, in_domain)
        ref = j_acam.get_table("silu", bits, enc, in_domain)
        np.testing.assert_array_equal(mine.lo, ref.lo)
        np.testing.assert_array_equal(mine.hi, ref.hi)
        assert mine.rows_per_bit == ref.rows_per_bit
        assert (mine.out_spec.lo, mine.out_spec.step) == \
            (ref.out_spec.lo, ref.out_spec.step)
        assert acam.get_table("silu", bits, enc, in_domain) is mine
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 64)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        acam.acam_activation(torch.from_numpy(x), "silu", 8,
                             in_domain).numpy(),
        np.asarray(j_acam.acam_activation(jnp.asarray(x), "silu", 8,
                                          in_domain)))
    w = rng.normal(size=(64, 24)).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        fused_linear_acam(torch.from_numpy(x), torch.from_numpy(w), "silu",
                          in_domain=in_domain).numpy(),
        np.asarray(j_fused_linear_acam(jnp.asarray(x), jnp.asarray(w),
                                       "silu", in_domain=in_domain)),
        rtol=0, atol=1e-6)


def test_fingerprint_covers_every_field():
    """Configs that differ in any one field key different radix roots."""
    cfgs = [ON] + [_configs(n)[0] for n in VARIANTS]
    fps = {nldpe_fingerprint(c) for c in cfgs}
    assert len(fps) == len(cfgs)
    assert nldpe_fingerprint(OFF) != nldpe_fingerprint(ON)


def _requests(trace):
    return [Request(rid=r.rid, tokens=r.tokens,
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, top_k=r.top_k, seed=r.seed,
                    arrival=r.arrival) for r in H.to_requests(trace)]


def test_on_engines_match_repro():
    """``ON`` numerics at float32 activations through the paged and the
    slotted engine: greedy tokens equal ``repro``'s, and inside the port
    paged equals slotted bitwise."""
    trace = H.shared_prefix_cow_trace(seed=41)[:4]
    kw = H.engine_kwargs()
    jon = JNLDPEConfig(enabled=True)
    ref = {c.rid: c.tokens for c in JPagedServeEngine(
        J_CFG32, H.shared_params(), nldpe=jon, page_size=H.PAGE,
        num_pages=H.NUM_PAGES, **kw).run(H.to_requests(trace))}
    params = from_jax(H.shared_params(), device="cpu")
    paged = {c.rid: c.tokens for c in PagedServeEngine(
        CFG32, params, nldpe=ON, page_size=H.PAGE, num_pages=H.NUM_PAGES,
        device="cpu", **kw).run(_requests(trace))}
    slotted = {c.rid: c.tokens for c in ServeEngine(
        CFG32, params, nldpe=ON, device="cpu", **kw).run(_requests(trace))}
    assert paged == slotted
    assert paged == ref
    j_slotted = {c.rid: c.tokens for c in JServeEngine(
        J_CFG32, H.shared_params(), nldpe=jon, **kw).run(
        H.to_requests(trace))}
    assert j_slotted == ref
