"""Mesh-sharded serving in the port equals single-device serving, token
for token (the exactness contract of the exact rule tables, DESIGN.md §9).

The mirror of tests/test_engine_sharded.py's matrix on the reduced
Qwen2.5-3B (4/2 heads, 2 slots, a zero-headroom page pool): each mesh
shape spawns its gloo ranks once (CPU tensors) and serves every cell of
that shape inside them; this process serves the same cells on
single-device engines.  Every rank must emit the single-device tokens,
with the same scheduling statistics (pool and spec counters) and no page
leak.  The port's single-device engines are held against ``repro``'s in
tests/test_torch_serve.py and the other engine suites.

* (2, 1) and (1, 2), paged: greedy and copy-on-write traces, spec 0 and 2;
* (1, 2): slotted and paged on the mixed sampled trace, FUSED at float32,
  int8 and log8 pools;
* (2, 2) and (2, 4), paged: greedy, COW and mixed; at TP 4 the 2 kv heads
  do not divide "model", so the pools replicate; FUSED at (2, 2), and the
  ``serve_dshard_exact`` table there (slots split, everything else
  replicated);
* (2, 1): ``ServeEngine(batch_groups=2)`` on the reduced Qwen3-MoE, whose
  routing groups follow the slot split.

``test_batch_groups_match_repro``: the same engine on one device against
``repro``'s ``ServeEngine(batch_groups=2)``.  The spawned ranks import
this module to find their function, so ``repro`` and jax are imported
inside that test only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import FUSED, OFF, NLDPEConfig
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.launch.mesh import run_ranks, serve_mesh
from repro_torch.models import lm

torch.set_num_threads(1)

MAX_LEN, PAGE, SLOTS = 24, 4, 2
NUM_PAGES = SLOTS * (-(-MAX_LEN // PAGE))
BASE = dict(max_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=4,
            decode_block=2)
STAT_KEYS = ("lookups", "hits", "hit_pages", "prefill_tokens_saved",
             "evicted", "cow_forks", "published", "gen_published")


# ---------------------------------------------------------------------------
# traces: tests/engine_harness.py's seeded generators, by name
# ---------------------------------------------------------------------------

def _trace(name: str, vocab: int):
    rng = np.random.default_rng({"greedy": 0, "mixed": 0, "cow": 17,
                                 "greedy1": 1}[name])
    if name == "cow":
        shared = tuple(int(x) for x in rng.integers(0, vocab, 2 * PAGE))
        return [(shared, 4, 0), (shared, 4, 3), (shared + (1, 2), 3, 2),
                (tuple(int(x) for x in rng.integers(0, 64, 11)), 5, 1),
                (shared, 2, 1),
                (tuple(int(x) for x in rng.integers(0, 64, 9)), 4, 0)]
    n = int(rng.integers(1, 6))
    if name.startswith("greedy"):
        return [(tuple(int(x) for x in rng.integers(
                    0, 3, int(rng.integers(1, 11)))),
                 int(rng.integers(1, 7)), int(rng.integers(0, 9)))
                for _ in range(n)]
    temps, topks = [0.0, 0.0, 0.7, 1.3], [0, 1, 3, vocab + 7]
    return [(tuple(int(x) for x in rng.integers(0, 3,
                                                int(rng.integers(1, 11)))),
             int(rng.integers(1, 6)), int(rng.integers(0, 7)),
             temps[int(rng.integers(0, 4))], topks[int(rng.integers(0, 4))])
            for _ in range(n)]


def _requests(trace, base_tick):
    reqs, t = [], 0
    for i, spec in enumerate(trace):
        prompt, gen, gap = spec[:3]
        temp, topk = (spec[3], spec[4]) if len(spec) > 3 else (0.0, 0)
        t += gap
        reqs.append(Request(rid=i, tokens=tuple(prompt), max_new_tokens=gen,
                            temperature=temp, top_k=topk,
                            arrival=base_tick + t))
    return reqs


# ---------------------------------------------------------------------------
# cells: (name, engine, arch, options, traces)
# ---------------------------------------------------------------------------

def _cell(name, engine="paged", arch="qwen2_5_3b", traces=("greedy",),
          **opts):
    return (name, engine, arch, opts, traces)


SPEC_CELLS = [_cell(f"paged spec{k}", traces=("greedy", "cow"), spec_k=k)
              for k in (0, 2)]
CELLS = {
    (2, 1): SPEC_CELLS + [
        _cell("moe slotted groups2", engine="slotted",
              arch="qwen3_moe_30b_a3b", traces=("greedy", "greedy1"),
              batch_groups=2)],
    (1, 2): SPEC_CELLS + [
        _cell("slotted mixed", engine="slotted", traces=("mixed",)),
        _cell("paged mixed", traces=("mixed",)),
        _cell("paged fused", traces=("greedy", "cow"), numerics="fused"),
        _cell("paged int8", traces=("greedy", "cow"), kv_quant="int8"),
        _cell("paged log8", traces=("greedy", "cow"), kv_quant="log8")],
    (2, 2): [_cell("paged", traces=("greedy", "cow", "mixed")),
             _cell("paged fused", traces=("greedy",), numerics="fused"),
             _cell("paged dshard", traces=("greedy",),
                   rules="serve_dshard_exact")],
    (2, 4): [_cell("paged", traces=("greedy", "cow", "mixed"))],
}


def _cfg(arch, get=get_config):
    """The reduced config; the MoE one with a capacity of one slot per
    expert and group, so that assignments drop and the routing groups
    matter."""
    cfg = get(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0, min_capacity=1))
    return cfg


def _engine(engine, arch, opts, mesh=None):
    cfg = _cfg(arch)
    opts = dict(opts)
    nldpe = OFF
    if opts.pop("numerics", None) == "fused":
        nldpe = FUSED
        cfg = dataclasses.replace(cfg, activation_dtype=torch.float32)
    params = lm.init_params(cfg, device="cpu")
    kw = dict(BASE, nldpe=nldpe, device="cpu", mesh=mesh, **opts)
    if engine == "slotted":
        return ServeEngine(cfg, params, **kw)
    if kw.get("spec_k"):
        kw["spec_draft"] = NLDPEConfig(enabled=False)
    return PagedServeEngine(cfg, params, page_size=PAGE,
                            num_pages=NUM_PAGES, **kw)


def _stats(eng) -> dict:
    st = {k: eng.stats[k] for k in STAT_KEYS} if hasattr(eng, "pool") \
        else {}
    if getattr(eng, "spec_k", 0):
        sp = eng.spec_stats
        st.update(drafted=sp["drafted"], accepted=sp["accepted"])
    if eng.moe_stats:
        st.update(eng.moe_stats)
    return st


def _serve(cells, mesh=None) -> dict:
    """Serve every cell's traces in order on one engine per cell: each
    trace's tokens and statistics deltas, and the leak audit."""
    out = {}
    for name, engine, arch, opts, traces in cells:
        eng = _engine(engine, arch, opts, mesh)
        vocab = eng.cfg.vocab_size
        for tname in traces:
            s0 = _stats(eng)
            comps = eng.run(_requests(_trace(tname, vocab), eng.tick))
            s1 = _stats(eng)
            delta = {k: s1[k] - s0[k] for k in s1}
            leak = None
            if hasattr(eng, "pool"):
                eng.pool.check()
                leak = (eng.free_slots, eng.pool.available())
            out[f"{name}/{tname}"] = ({c.rid: c.tokens for c in comps},
                                      delta, leak)
    return out


def _rank(mesh_shape, cells, device):
    return _serve(cells, serve_mesh(*mesh_shape, device))


@pytest.mark.parametrize("mesh_shape", list(CELLS), ids=str)
def test_sharded_serving_equals_single_device(mesh_shape):
    cells = CELLS[mesh_shape]
    want = _serve(cells)
    for key, (_, _, leak) in want.items():
        if leak is not None:
            assert leak == (SLOTS, NUM_PAGES), key
    got = run_ranks(_rank, mesh_shape[0] * mesh_shape[1],
                    (mesh_shape, cells))
    for rank, res in enumerate(got):
        assert set(res) == set(want)
        for key in want:
            assert res[key][0] == want[key][0], (mesh_shape, rank, key)
            assert res[key][1] == want[key][1], (mesh_shape, rank, key)
            assert res[key][2] == want[key][2], (mesh_shape, rank, key)


def test_batch_groups_match_repro():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.launch.engine import Request as JRequest
    from repro.launch.engine import ServeEngine as JServeEngine
    from repro.models import lm as j_lm
    from repro.nn.module import param_dtype

    from repro_torch.convert import from_jax

    j_cfg = dataclasses.replace(_cfg("qwen3_moe_30b_a3b", j_get_config),
                                activation_dtype=jnp.float32)
    cfg = dataclasses.replace(_cfg("qwen3_moe_30b_a3b"),
                              activation_dtype=torch.float32)
    with param_dtype(jnp.float32):
        jp = j_lm.init_params(jax.random.key(0), j_cfg)
    ref = JServeEngine(j_cfg, jp, batch_groups=2, **BASE)
    port = ServeEngine(cfg, from_jax(jp, device="cpu"), batch_groups=2,
                       device="cpu", **BASE)
    for tname in ("greedy", "greedy1"):
        trace = _trace(tname, cfg.vocab_size)
        got = {c.rid: c.tokens
               for c in port.run(_requests(trace, port.tick))}
        jreqs = [JRequest(rid=r.rid, tokens=r.tokens,
                          max_new_tokens=r.max_new_tokens,
                          arrival=r.arrival)
                 for r in _requests(trace, ref.tick)]
        want = {c.rid: c.tokens for c in ref.run(jreqs)}
        assert got == want, tname
    assert port.moe_stats["dropped_prefill"] > 0


def test_mesh_refusals():
    """What the mesh does not serve yet raises, naming ROADMAP A.2: a
    table that shards a contraction, the async pipeline, recurrent and
    RWKV6 blocks under a sharding context."""
    from repro_torch.launch.async_engine import AsyncServeEngine
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.parallel.context import sharding_ctx
    from repro_torch.parallel.sharding import serve_exact_rules
    cfg = get_config("qwen2_5_3b", reduced=True)
    params = lm.init_params(cfg, device="cpu")
    one = single_device_mesh()
    for rules in ("serve", "long", "serve_dshard", "train", "train_fsdp"):
        with pytest.raises(NotImplementedError, match="A.2"):
            ServeEngine(cfg, params, mesh=one, rules=rules, device="cpu",
                        **BASE)
    with pytest.raises(ValueError, match="unknown rule table"):
        ServeEngine(cfg, params, mesh=one, rules="nope", device="cpu",
                    **BASE)
    eng = ServeEngine(cfg, params, mesh=one, device="cpu", **BASE)
    assert eng.rules.name == "serve_exact"
    with pytest.raises(NotImplementedError, match="A.2"):
        AsyncServeEngine(eng)
    rg = get_config("recurrentgemma_9b", reduced=True)
    rp = lm.init_params(rg, device="cpu")
    with sharding_ctx(one, serve_exact_rules()):
        with pytest.raises(NotImplementedError, match="A.2"):
            lm.forward(rp, torch.zeros((1, 4), dtype=torch.int32), rg,
                       mode="prefill")


def test_one_rank_mesh_serves_the_single_device_tokens():
    """A (1, 1) mesh (no process group) runs the sharded code paths with
    every placement replicated: the tokens are mesh=None's."""
    from repro_torch.launch.mesh import single_device_mesh
    cells = [_cell("paged", traces=("greedy", "cow")),
             _cell("slotted", engine="slotted", traces=("mixed",))]
    assert _serve(cells, single_device_mesh()) == _serve(cells)


def test_cli_mesh_flags_are_validated(capsys):
    from repro_torch.launch.serve import run
    for argv, msg in ((["--mesh", "2,2"], "requires an engine demo"),
                      (["--paged", "--mesh-rules", "serve_exact"],
                       "--mesh-rules requires --mesh"),
                      (["--paged", "--mesh", "2,x"], "DP,TP"),
                      (["--paged", "--mesh", "1,2", "--async-serve"],
                       "not ported yet"),
                      (["--paged", "--mesh", "1,2", "--mesh-rules",
                        "serve"], "invalid choice")):
        with pytest.raises(SystemExit):
            run(argv + ["--device", "cpu"])
        assert msg in capsys.readouterr().err, argv


def test_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                         serve_mesh)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        serve_mesh(2, 2)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    m = make_mesh((1, 1), ("data", "model"))
    assert m.coords == {"data": 0, "model": 0} and m.size == 1


def test_cli_mesh_serves_the_unsharded_tokens():
    """``--mesh 2,1`` spawns its gloo ranks; rank 0's completions are the
    command's without ``--mesh``, request for request."""
    from repro_torch.launch.serve import run
    argv = ["--continuous", "--requests", "4", "--slots", "2",
            "--prompt-len", "8", "--gen-len", "6", "--device", "cpu"]
    want = run(argv)
    got = run(argv + ["--mesh", "2,1"])
    assert [(c.rid, c.tokens) for c in got] == \
        [(c.rid, c.tokens) for c in want]
