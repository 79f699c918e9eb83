"""The port's lockstep serve path and slotted ``ServeEngine`` held against
``repro`` on the CPU, on the shared harness (tests/engine_harness.py: the
reduced Qwen2.5-3B with ``repro``'s seeded weights through
``convert.from_jax``).

* Lockstep whole-prompt prefill + greedy generation against
  ``repro.launch.serve``'s jitted functions, OFF and FUSED, at float32
  activations: last prefill logits within 1e-5 (f32 sums in another
  order; FUSED: the plain log-domain attention against ``repro``'s Pallas
  kernel in interpret mode, measured 4.8e-7) and equal tokens.
* ``ServeEngine`` against ``repro``'s on the harness's greedy traces (OFF,
  the harness's bf16 activations, near-tie guarded as in
  tests/test_torch_serve.py) and mixed greedy/temperature/top-k traces
  (float32 activations, where the threefry draws make sampled tokens
  comparable): equal tokens.
* Inside the port, where every path runs its plain version: paged ==
  slotted == lockstep-alone greedy tokens, bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
from repro.core.engine import NLDPEConfig as JNLDPEConfig
from repro.launch import serve as j_serve
from repro.launch.engine import ServeEngine as JServeEngine
from repro.models import lm as j_lm

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import FUSED, OFF
from repro_torch.launch import serve
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.models import lm

torch.set_num_threads(1)

CFG = get_config("qwen2_5_3b", reduced=True)
CFG32 = dataclasses.replace(CFG, activation_dtype=torch.float32)
J_CFG32 = dataclasses.replace(H.CFG, activation_dtype=jnp.float32)
J_FUSED = JNLDPEConfig(enabled=True, fused_dual_compute=True)
TIE_MARGIN = 0.02                   # OFF at bf16, as tests/test_torch_serve.py


def _params(device="cpu"):
    return from_jax(H.shared_params(), device=device)


def _port_requests(reqs):
    return [Request(rid=r.rid, tokens=r.tokens,
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, top_k=r.top_k, seed=r.seed,
                    arrival=r.arrival) for r in reqs]


@pytest.mark.parametrize("fused", [False, True], ids=["OFF", "FUSED"])
def test_lockstep_prefill_and_generate_match_repro(fused):
    """Prefill 2 prompts of 12 tokens, then generate 6: ``repro``'s jitted
    prefill step and scanned generate fn against the port's."""
    b, plen, gen, max_len = 2, 12, 6, 20
    prompts = np.random.default_rng(3).integers(0, CFG.vocab_size,
                                                (b, plen)).astype(np.int32)
    jn = J_FUSED if fused else JNLDPEConfig()
    cache = j_lm.init_model_cache(J_CFG32, b, max_len, dtype=jnp.float32)
    last, cache = jax.jit(j_serve.build_prefill_step(J_CFG32, nldpe=jn))(
        H.shared_params(), cache, jnp.asarray(prompts))
    tok0 = jnp.argmax(last, axis=-1).astype(jnp.int32)
    ref_tokens, _ = j_serve.build_generate_fn(J_CFG32, gen, nldpe=jn)(
        H.shared_params(), cache, tok0, jnp.int32(plen))

    nldpe = FUSED if fused else OFF
    params = lm.serving_params(_params(), CFG32, nldpe)
    cache = lm.init_model_cache(CFG32, b, max_len, device="cpu")
    mine, cache = serve.build_prefill_step(CFG32, nldpe=nldpe)(
        params, cache, torch.from_numpy(prompts))
    np.testing.assert_allclose(mine.numpy(), np.asarray(last), rtol=0,
                               atol=1e-5)
    tok = torch.argmax(mine, dim=-1).to(torch.int32)
    tokens, _ = serve.build_generate_fn(CFG32, gen, nldpe=nldpe)(
        params, cache, tok, plen)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))


def test_generate_fn_equals_python_loop_and_fills_the_ring():
    """The generate fn and the per-token loop give the same tokens; the
    prefill fills the lockstep ring with positions 0..S-1."""
    params = lm.serving_params(_params(), CFG, OFF)
    prompts = torch.tensor(np.random.default_rng(4).integers(
        0, CFG.vocab_size, (3, 9)), dtype=torch.int32)
    out = []
    for loop in (False, True):
        cache = lm.init_model_cache(CFG, 3, 16, device="cpu")
        last, cache = serve.build_prefill_step(CFG)(params, cache, prompts)
        assert cache["pos"].tolist() == list(range(9)) + [-1] * 7
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        if loop:
            gen, cache = serve.python_loop_decode(
                serve.build_decode_step(CFG), params, cache, tok, 9, 7)
        else:
            gen, cache = serve.build_generate_fn(CFG, 7)(params, cache,
                                                         tok, 9)
        assert cache["pos"].tolist() == list(range(15)) + [-1]
        out.append(gen)
    assert torch.equal(out[0], out[1])


def test_generate_fn_raises_on_overflow_like_repro():
    cache = lm.init_model_cache(CFG, 1, 8, device="cpu")
    params = lm.serving_params(_params(), CFG, OFF)
    tok = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows the KV cache"):
        serve.build_generate_fn(CFG, 4)(params, cache, tok, 6)
    j_cache = j_lm.init_model_cache(H.CFG, 1, 8, dtype=jnp.float32)
    with pytest.raises(ValueError, match="overflows the KV cache"):
        j_serve.build_generate_fn(H.CFG, 4)(H.shared_params(), j_cache,
                                            jnp.zeros((1,), jnp.int32),
                                            jnp.int32(6))
    # exactly at capacity is fine (positions 5..7)
    serve.build_generate_fn(CFG, 3)(params, cache, tok, 5)


def _margin(tokens) -> float:
    logits, _ = j_lm.forward(H.shared_params(),
                             jnp.asarray([tokens], jnp.int32), H.CFG,
                             mode="train")
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


_ENGINES = {}


def _engines(f32: bool):
    """(repro, port) slotted engines with the harness settings."""
    if f32 not in _ENGINES:
        kw = H.engine_kwargs()
        _ENGINES[f32] = (
            JServeEngine(J_CFG32 if f32 else H.CFG, H.shared_params(), **kw),
            ServeEngine(CFG32 if f32 else CFG, _params(), device="cpu",
                        **kw))
    return _ENGINES[f32]


def _serve_both(trace, f32: bool) -> int:
    ref_eng, port_eng = _engines(f32)
    ref = {c.rid: c for c in ref_eng.run(H.to_requests(trace,
                                                       ref_eng.tick))}
    got = {c.rid: c for c in port_eng.run(_port_requests(
        H.to_requests(trace, port_eng.tick)))}
    assert sorted(got) == sorted(ref) == list(range(len(trace)))
    ties = 0
    for rid, c in ref.items():
        mine = got[rid]
        assert len(mine.tokens) == len(c.tokens)
        assert mine.finish_reason == c.finish_reason
        if mine.tokens != c.tokens:
            assert not f32, (rid, mine.tokens, c.tokens)
            i = next(i for i, (a, b) in enumerate(zip(mine.tokens, c.tokens))
                     if a != b)
            margin = _margin(tuple(c.prompt) + tuple(c.tokens[:i]))
            assert margin < TIE_MARGIN, (rid, margin)
            ties += 1
    assert port_eng.free_slots == port_eng.max_slots
    return ties


@pytest.mark.parametrize("seed", [0, 1])
def test_slotted_engine_greedy_traces_match_repro(seed):
    trace = H.random_greedy_trace(np.random.default_rng(seed))
    assert _serve_both(trace, f32=False) <= 1


@pytest.mark.parametrize("seed", [0, 3])
def test_slotted_engine_mixed_traces_match_repro(seed):
    """Greedy, temperature and top-k requests sharing decode blocks: the
    sampled tokens are ``repro``'s (float32 activations)."""
    rng = np.random.default_rng(seed)
    trace = H.random_mixed_trace(rng) + H.random_mixed_trace(rng)
    assert any(t[3] > 0 for t in trace)
    _serve_both(trace, f32=True)


def _alone(params, prompt, gen):
    """Lockstep oracle inside the port: whole-prompt prefill +
    ``python_loop_decode``, one request alone."""
    cache = lm.init_model_cache(CFG, 1, H.MAX_LEN, device="cpu")
    last, cache = serve.build_prefill_step(CFG)(
        params, cache, torch.tensor([prompt], dtype=torch.int32))
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    out, _ = serve.python_loop_decode(serve.build_decode_step(CFG), params,
                                      cache, tok, len(prompt), gen)
    return out[0].tolist()


def test_paged_equals_slotted_equals_lockstep_inside_port():
    """Greedy tokens of one trace through the paged engine (zero-headroom
    pool, shared prefixes, COW), the slotted engine and each request run
    alone in lockstep: bitwise equal."""
    trace = H.shared_prefix_cow_trace(seed=31) + H.random_greedy_trace(
        np.random.default_rng(9))
    reqs = _port_requests(H.to_requests(trace))
    params = _params()
    kw = H.engine_kwargs()
    slotted = ServeEngine(CFG, params, device="cpu", **kw).run(reqs)
    paged = PagedServeEngine(CFG, params, device="cpu", page_size=H.PAGE,
                             num_pages=H.NUM_PAGES, **kw).run(reqs)
    served = lm.serving_params(params, CFG, OFF)
    for s, p, r in zip(slotted, paged, reqs):
        assert s.tokens == p.tokens == _alone(served, r.tokens,
                                              r.max_new_tokens), r.rid


def test_cli_lockstep_and_continuous_on_cpu(capsys):
    scan = serve.run(["--device", "cpu", "--batch", "2", "--prompt-len",
                      "6", "--gen-len", "4"])
    loop = serve.run(["--device", "cpu", "--batch", "2", "--prompt-len",
                      "6", "--gen-len", "4", "--python-loop"])
    assert torch.equal(scan, loop) and scan.shape == (2, 4)
    comps = serve.run(["--device", "cpu", "--continuous", "--requests", "3",
                       "--prompt-len", "8", "--gen-len", "4"])
    assert len(comps) == 3 and all(c.tokens for c in comps)
    out = capsys.readouterr().out
    assert "generate fn" in out and "python loop" in out
    assert "[serve] continuous" in out


@pytest.mark.parametrize("argv", [["--continuous", "--paged"],
                                  ["--page-size", "8"],
                                  ["--slots", "2"],
                                  ["--continuous", "--python-loop"],
                                  ["--paged", "--batch", "2"]])
def test_cli_rejects_incoherent_flags_like_repro(argv):
    with pytest.raises(SystemExit):
        serve.run(["--device", "cpu", *argv])


def test_slotted_chunk_tail_wraps_like_repro():
    """``repro``'s slotted cache is a ring: when ``max_len`` is not a
    multiple of the prefill chunk, a prompt that reaches the last partial
    chunk writes its padded tail over lines 0.. and loses its first
    positions (its first token differs from the same prompt at a larger
    ``max_len``).  The port keeps the reference's behavior, token for
    token (recorded in ROADMAP.md as a fault of the reference)."""
    prompt = tuple(int(x) for x in np.random.default_rng(0).integers(
        0, CFG.vocab_size, 30))
    got = {}
    for max_len in (30, 32):
        kw = dict(max_slots=1, max_len=max_len, prefill_chunk=4,
                  decode_block=2)
        got[max_len] = ServeEngine(CFG, _params(), device="cpu", **kw).run(
            [Request(rid=0, tokens=prompt, max_new_tokens=1)])[0].tokens
    ref = JServeEngine(H.CFG, H.shared_params(), max_slots=1, max_len=30,
                       prefill_chunk=4, decode_block=2).run(
        H.to_requests([(prompt, 1, 0)]))
    assert got[30] == ref[0].tokens != got[32]
