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

``test_serve_table_equals_single_device_up_to_near_ties``: the ``serve``
table, whose output and down projections sum partial products over
"model" and whose vocab is split: paged and slotted, OFF and FUSED (at
float32), at (1, 2) and (2, 2).  Greedy tokens equal the single-device
engines' up to near-ties (a divergence's single-device top-2 margin below
``TIE_MARGIN``, at most once a cell), kernels A's and B's plain versions
run once per shard for each single-device call, and a sharded prefill's
logits are within ``LOGIT_TOL`` of the single-device ones.
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
TIE_MARGIN = 0.02       # the spec tests' near-tie rule
LOGIT_TOL = 1e-5        # float32 partial sums in another order
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


# the serve table's cells: (name, engine, numerics), greedy traces
SERVE_CELLS = [(f"{eng} {num}", eng, num)
               for eng in ("paged", "slotted") for num in ("off", "fused")]
PLAIN = {"paged_attention": ("repro_torch.kernels.paged_attention.ops",
                             "paged_attention_ref"),
         "fused_crossbar_acam": ("repro_torch.kernels.dual_compute.ops",
                                 "fused_crossbar_acam_ref")}


def _counting_plain() -> dict:
    """Count the calls of kernels A's and B's plain versions (what the
    CPU wrappers run in their launch's place)."""
    import importlib
    counts = dict.fromkeys(PLAIN, 0)
    for name, (mod, fn) in PLAIN.items():
        m = importlib.import_module(mod)
        plain = getattr(m, fn)

        def counted(*a, _plain=plain, _name=name, **kw):
            counts[_name] += 1
            return _plain(*a, **kw)
        setattr(m, fn, counted)
    return counts


def _serve_table(mesh=None) -> dict:
    """Every ``SERVE_CELLS`` cell's greedy tokens (the greedy and COW
    traces) and plain-version calls, then a prefill's logits (this rank's
    rows) at float32, on ``mesh`` under ``serve`` (or one device)."""
    from repro_torch.nn.module import shard_tree, spec_tree
    from repro_torch.parallel import sharding
    from repro_torch.parallel.context import sharding_ctx
    counts = _counting_plain()
    out = {}
    for name, engine, num in SERVE_CELLS:
        opts = {"numerics": num} if num == "fused" else {}
        if mesh is not None:
            opts["rules"] = "serve"
        eng = _engine(engine, "qwen2_5_3b", opts, mesh)
        toks = {}
        for tname in ("greedy", "cow"):
            before = dict(counts)
            comps = eng.run(_requests(_trace(tname, eng.cfg.vocab_size),
                                      eng.tick))
            toks[tname] = {c.rid: c.tokens for c in comps}
            toks[tname + " calls"] = {k: counts[k] - before[k]
                                      for k in counts}
        out[name] = toks
    cfg = dataclasses.replace(_cfg("qwen2_5_3b"),
                              activation_dtype=torch.float32)
    params = lm.init_params(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 12)).astype(np.int32))
    with torch.no_grad():
        if mesh is None:
            out["logits"] = lm.forward(params, tokens, cfg, mode="prefill")
        else:
            rules = sharding.serve_rules()
            local = shard_tree(params, spec_tree(params, cfg, mesh, rules),
                               mesh)
            with sharding_ctx(mesh, rules, batch=4):
                rows = sharding.Spec((sharding.resolve(
                    rules, ("batch",), (4,), mesh).axes_of(0),))
                out["logits"] = lm.forward(local, rows.local(tokens, mesh),
                                           cfg, mode="prefill")
                out["rows"] = rows
    out["logits"] = out["logits"].numpy()
    return out


def _margin(engine_num: str, prompt, toks) -> float:
    """The single-device top-2 logit margin after ``prompt + toks``."""
    cfg = _cfg("qwen2_5_3b")
    nldpe = OFF
    if engine_num == "fused":
        nldpe = FUSED
        cfg = dataclasses.replace(cfg, activation_dtype=torch.float32)
    params = lm.init_params(cfg, device="cpu")
    seq = torch.tensor([list(prompt) + list(toks)], dtype=torch.int32)
    with torch.no_grad():
        logits = lm.forward(params, seq, cfg, mode="prefill", nldpe=nldpe)
    top = torch.sort(logits[0, -1]).values[-2:]
    return float(top[1] - top[0])


def _near_ties(num: str, trace, got: dict, want: dict) -> int:
    """Assert ``got`` == ``want`` per request up to near-ties; the number
    of ties."""
    ties = 0
    for rid, toks in want.items():
        mine = got[rid]
        if mine == toks:
            continue
        i = next((i for i, (a, b) in enumerate(zip(mine, toks)) if a != b),
                 min(len(mine), len(toks)))
        m = _margin(num, trace[rid][0], toks[:i])
        assert m < TIE_MARGIN, (rid, i, m, mine, toks)
        ties += 1
    return ties


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)], ids=str)
def test_serve_table_equals_single_device_up_to_near_ties(mesh_shape):
    want = _serve_table()
    got = run_ranks(_serve_rank_worker, mesh_shape[0] * mesh_shape[1],
                    (mesh_shape,))
    vocab = _cfg("qwen2_5_3b").vocab_size
    for rank, res in enumerate(got):
        for name, _, num in SERVE_CELLS:
            ties = 0
            for tname in ("greedy", "cow"):
                ties += _near_ties(num, _trace(tname, vocab),
                                   res[name][tname], want[name][tname])
                # every single-device call of A (paged OFF) or B (FUSED)
                # is one call on each shard
                assert res[name][tname + " calls"] == \
                    want[name][tname + " calls"], (rank, name, tname)
            assert ties <= 1, (mesh_shape, rank, name)
        rows = res["rows"].local(torch.from_numpy(want["logits"]),
                                 res["mesh"]).numpy()
        np.testing.assert_allclose(res["logits"], rows, rtol=0,
                                   atol=LOGIT_TOL)
    assert want["paged off"]["greedy calls"]["paged_attention"] > 0
    assert want["paged fused"]["greedy calls"]["fused_crossbar_acam"] > 0


def _serve_rank_worker(mesh_shape, device):
    mesh = serve_mesh(*mesh_shape, device)
    res = _serve_table(mesh)
    res["mesh"] = _MeshView(mesh.shape, mesh.coords)
    return res


class _MeshView:
    """A picklable stand-in for a rank's mesh (``Spec.local`` reads its
    ``shape`` and ``coords``)."""

    def __init__(self, shape, coords):
        self.shape, self.coords = dict(shape), dict(coords)


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
    """What the mesh does not serve yet raises, naming its item of ROADMAP
    A.2's queue: ``serve_dshard`` (1), ``long`` and a placement that
    splits a cache's positions (2: context-parallel paged decode),
    recurrent and RWKV6 blocks under a sharding context (3), the async
    pipeline (4); the train tables are not served; ``serve`` is."""
    from repro_torch.launch.async_engine import AsyncServeEngine
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.parallel.context import Mesh, sharding_ctx
    from repro_torch.parallel.sharding import serve_exact_rules
    cfg = get_config("qwen2_5_3b", reduced=True)
    params = lm.init_params(cfg, device="cpu")
    one = single_device_mesh()
    for rules, why in (("serve_dshard", "item 1: serve_dshard"),
                       ("long", "item 2: long"),
                       ("train", "training table"),
                       ("train_fsdp", "training table")):
        with pytest.raises(NotImplementedError, match=why):
            ServeEngine(cfg, params, mesh=one, rules=rules, device="cpu",
                        **BASE)
    with pytest.raises(ValueError, match="unknown rule table"):
        ServeEngine(cfg, params, mesh=one, rules="nope", device="cpu",
                    **BASE)
    assert ServeEngine(cfg, params, mesh=one, rules="serve", device="cpu",
                       **BASE).rules.name == "serve"
    # 2 kv heads over a "model" axis of 4: the slotted cache's positions
    # would split ("kv_seq"); the placement is refused before any
    # collective, so a mesh view without process groups shows it
    four = Mesh(shape={"data": 1, "model": 4})
    with pytest.raises(NotImplementedError, match="item 2"):
        ServeEngine(cfg, params, mesh=four, rules="serve", device="cpu",
                    **BASE)
    eng = ServeEngine(cfg, params, mesh=one, device="cpu", **BASE)
    assert eng.rules.name == "serve_exact"
    with pytest.raises(NotImplementedError, match="item 4"):
        AsyncServeEngine(eng)
    rg = get_config("recurrentgemma_9b", reduced=True)
    rp = lm.init_params(rg, device="cpu")
    with sharding_ctx(one, serve_exact_rules()):
        with pytest.raises(NotImplementedError, match="item 3"):
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
                        "long"], "invalid choice")):
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
