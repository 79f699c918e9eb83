"""The port's placements held against ``repro``'s ``PartitionSpec``s.

For every reduced architecture, rule table and mesh shape, the port's
``nn.module.spec_tree`` (parameters) and ``models.lm.cache_pspecs``
(caches: lockstep, slotted and paged; fp, int8 and log8) must resolve
every leaf to the placement ``repro`` resolves for it.  ``repro``'s
resolver reads only ``mesh.shape``, so a stand-in mesh with a ``shape``
mapping runs both in this process, with no devices forced.

The port keeps one stack per kind of layer state (K/V and scales led by
the stack's layer axis, one position track per stack); ``repro`` keeps a
subtree per block.  Each port leaf is compared with the leaf of every
layer it holds (the layer axis dropped), trailing unsplit dimensions
ignored on both sides.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as j_lm
from repro.nn.module import spec_tree as j_spec_tree
from repro.parallel import sharding as j_sharding

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.nn.module import param_axes, spec_tree
from repro_torch.parallel import sharding

ARCHS = ("qwen3_moe_30b_a3b", "llama4_scout_17b_a16e", "qwen2_7b",
         "gemma3_27b", "minicpm_2b", "qwen2_5_3b", "recurrentgemma_9b",
         "paligemma_3b", "rwkv6_3b", "musicgen_large")
TABLES = ("train", "serve", "long", "train_fsdp", "serve_dshard",
          "serve_exact")
MESHES = ((2, 1), (1, 2), (2, 2), (2, 4))
BATCH, MAX_LEN = 4, 32


@dataclasses.dataclass
class StandIn:
    """A mesh as both resolvers read it: axis name -> size."""
    shape: dict


def _mesh(dp, tp):
    return StandIn({"data": dp, "model": tp})


def _norm(spec) -> tuple:
    """A spec as a tuple: one-axis tuples as the axis (``PartitionSpec``
    writes ('data',) as 'data'), trailing unsplit dims dropped."""
    t = tuple(tuple(a) if isinstance(a, (list, tuple)) else a for a in spec)
    t = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
              for a in t)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _is_pspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_repro(arch, table):
    cfg = get_config(arch, reduced=True)
    j_cfg = j_get_config(arch, reduced=True)
    params = lm.init_params(cfg, device="cpu")
    rules = sharding.rules_for(table, False)
    j_rules = j_sharding.rules_for(table, False)
    assert rules.table == {k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in j_rules.table.items()}
    for dp, tp in MESHES:
        mesh = _mesh(dp, tp)
        want = j_spec_tree(lambda k: j_lm.init_params(k, j_cfg),
                           jax.random.key(0), mesh, j_rules)
        got = spec_tree(params, cfg, mesh, rules)
        got_leaves = dict(_leaves(got))
        want_leaves = dict(
            (tuple(getattr(k, "key", k) for k in path), v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=_is_pspec)[0])
        assert set(got_leaves) == set(want_leaves), (arch, dp, tp)
        for path, spec in got_leaves.items():
            assert _norm(spec) == _norm(want_leaves[path]), \
                (arch, table, (dp, tp), path, spec, want_leaves[path])


def test_param_axes_mirror_init_params():
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        params = lm.init_params(cfg, device="cpu")
        axes = dict(_leaves(param_axes(cfg)))
        for path, leaf in _leaves(params):
            assert len(axes[path]) == leaf.dim(), (arch, path)
        assert set(axes) == {p for p, _ in _leaves(params)}


def _cache_cases(cfg):
    """(kind, kwargs) cache layouts the port builds for ``cfg``."""
    out = [("lockstep", {}), ("slotted", dict(slotted=True, ring_slack=3))]
    if all(lm._stack_of(cfg, t) == "full" for t in cfg.layer_pattern):
        out.append(("paged", dict(paged=(12, 4))))
    return out


def _repro_block_cache(jspecs, where, key, g):
    tree = jspecs[where][key]
    if g is None:
        return tree
    return jax.tree.map(lambda s: jax.sharding.PartitionSpec(*tuple(s)[1:]),
                        tree, is_leaf=_is_pspec)


def _port_layer_leaves(cfg, specs, st):
    """The port stack's leaves, the layer axis of stacked ones dropped."""
    stack = lm.stacks(specs)[st] if st != "full" else {
        k: v for k, v in specs.items() if k in ("k", "v", "pos", "bt",
                                                "k_scale", "v_scale")}
    out = {}
    for path, spec in _leaves(stack):
        out[path] = (spec if path[-1] in ("pos", "bt")
                     else sharding.Spec(tuple(spec)[1:]))
    return out


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placements_match_repro(arch, table):
    rules = sharding.rules_for(table, False)
    j_rules = j_sharding.rules_for(table, False)
    for quant in ("bf16", "int8", "log8"):
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  kv_cache_dtype=quant)
        j_cfg = dataclasses.replace(j_get_config(arch, reduced=True),
                                    kv_cache_dtype=quant)
        for kind, kw in _cache_cases(cfg):
            cache = lm.init_model_cache(cfg, BATCH, MAX_LEN, device="cpu",
                                        **kw)
            for dp, tp in MESHES:
                mesh = _mesh(dp, tp)
                specs = lm.cache_pspecs(cfg, BATCH, MAX_LEN, mesh, rules,
                                        **kw)
                # the spec tree mirrors the cache, leaf for leaf
                got = dict(_leaves(specs))
                have = dict(_leaves(cache))
                assert set(got) == set(have), (arch, kind)
                for path, leaf in have.items():
                    assert len(got[path]) in (0, leaf.dim()), (path, kind)
                jspecs = j_lm.cache_pspecs(j_cfg, BATCH, MAX_LEN, mesh,
                                           j_rules, **kw)
                for (btype, where, key, g), (st, _) in zip(
                        lm.layer_order(cfg), lm.cache_slots(cfg)):
                    want = _repro_block_cache(jspecs, where, key, g)
                    if st in ("full", "ring"):
                        want = want["attn"]
                    elif st == "rec":
                        want = want["rec"]
                    for path, spec in _port_layer_leaves(cfg, specs,
                                                         st).items():
                        w = _get(want, path)
                        assert _norm(spec) == _norm(w), \
                            (arch, table, quant, kind, (dp, tp), btype,
                             path, spec, w)


def test_exact_drops_exactly_the_inexact_axes():
    assert sharding.INEXACT_AXES == j_sharding.INEXACT_AXES
    for table in TABLES:
        r = sharding.rules_for(table)
        e = sharding.exact(r)
        for ax, v in r.table.items():
            want = None if ax in sharding.INEXACT_AXES else v
            assert e.table[ax] == want, (table, ax)
        assert sharding.is_exact(e)
        assert e.name == f"{table}_exact"
        assert e.table == {k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in sharding.exact(r).table.items()}
    assert sharding.serve_exact_rules().table == \
        sharding.exact(sharding.serve_rules()).table
    assert not sharding.is_exact(sharding.serve_rules())
    with pytest.raises(ValueError, match="unknown rule table"):
        sharding.rules_for("nope")


def test_resolver_falls_back_and_uses_each_axis_once():
    r = sharding.rules_for("train_fsdp")
    m = _mesh(2, 4)
    # batch takes both axes; heads cannot reuse "model"
    spec = sharding.resolve(r, ("batch", "heads"), (8, 8), m)
    assert tuple(spec) == (("data", "model"), None)
    # 2 rows do not divide data x model = 8: the first sub-axis alone
    assert tuple(sharding.resolve(r, ("batch",), (2,), m)) == ("data",)
    # 3 heads do not divide model = 4: replicated
    s = sharding.resolve(sharding.serve_rules(), ("heads",), (3,), m)
    assert tuple(s) == (None,)
    assert tuple(sharding.resolve(r, ("batch",), (8,), None)) == ()
    mm = StandIn({"data": 2, "model": 4})
    mm.coords = {"data": 1, "model": 2}
    x = torch.arange(8 * 8).reshape(8, 8)
    loc = sharding.Spec(("data", "model")).local(x, mm)
    assert torch.equal(loc, x[4:8, 4:6])


def test_layout_helpers_reach_every_stack_by_name():
    cases = {"qwen2_5_3b": {"full"}, "gemma3_27b": {"full", "ring"},
             "recurrentgemma_9b": {"ring", "rec"}, "rwkv6_3b": {"rwkv"}}
    for arch, names in cases.items():
        cfg = get_config(arch, reduced=True)
        cache = lm.init_model_cache(cfg, 2, 24, slotted=True, device="cpu")
        st = lm.stacks(cache)
        assert set(st) == names, arch
        assert set(lm.attention_stacks(cache)) == names & {"full", "ring"}
        used = {s for s, _ in lm.cache_slots(cfg)}
        assert used == names, arch
        # the full stack's tensors are the cache's own
        if "full" in st:
            st["full"]["pos"][0, 0] = 7
            assert int(cache["pos"][0, 0]) == 7
        assert len(lm.position_tracks(cache)) == len(
            names & {"full", "ring"})


class _ShardAt(StandIn):
    def __init__(self, dp, tp, d, m):
        super().__init__({"data": dp, "model": tp})
        self.coords = {"data": d, "model": m}


@pytest.mark.parametrize("pool", ["float32", "int8", "log8"])
@pytest.mark.parametrize("q_len", [1, 3])
def test_paged_attention_sharded_is_the_unsharded_slice(pool, q_len):
    """Kernel A's plain version launched per shard, on each shard's cut
    of the operands at ``shard_specs``'s placement (heads over "model"
    where both head counts divide it, sequences over "data", pages
    shared, a quantized pool's scales on its head axis), equals the
    unsharded call's slice bitwise."""
    import numpy as np
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_sharded, shard_specs)
    from repro_torch.nn.attention import _quantize_kv
    rng = np.random.default_rng(3)
    b, hq, hkv, p, nb, ps, d = 4, 8, 4, 24, 5, 4, 16
    q = torch.tensor(rng.normal(size=(b, hq, q_len, d)), dtype=torch.float32)
    kp, vp = (torch.tensor(rng.normal(size=(p, hkv, ps, d)),
                           dtype=torch.float32) for _ in range(2))
    bt = torch.tensor(rng.permutation(p)[:b * nb].reshape(b, nb),
                      dtype=torch.int32)
    lengths = torch.tensor(rng.integers(1, nb * ps - q_len + 2, b),
                           dtype=torch.int32)
    kw = {}
    if pool != "float32":
        kp, ks = _quantize_kv(kp, pool)
        vp, vs = _quantize_kv(vp, pool)
        kw = dict(k_scale=ks, v_scale=vs, kv_quant=pool)
    full = paged_attention(q, kp, vp, bt, lengths, **kw)
    rules = sharding.serve_exact_rules()
    for dp, tp in MESHES + ((1, 8),):
        for dd in range(dp):
            for m in range(tp):
                at = _ShardAt(dp, tp, dd, m)
                sp = shard_specs(b, hq, hkv, at, rules)

                def cut(t, name):
                    return sp[name].local(t, at).contiguous()
                local = {k: cut(v, "pool") for k, v in kw.items()
                         if k != "kv_quant"}
                got = paged_attention_sharded(
                    cut(q, "q"), cut(kp, "pool"), cut(vp, "pool"),
                    cut(bt, "table"), cut(lengths, "table"), at, rules,
                    n_heads=hq, n_kv_heads=hkv, kv_quant=kw.get("kv_quant"),
                    **local)
                assert torch.equal(got, sp["q"].local(full, at))
                # (1, 8): 4 kv heads do not divide 8 — replicated heads
                assert got.shape[1] == (hq if tp == 8 else hq // tp)


def test_paged_attention_sharded_refuses_another_head_slice():
    """Operands that are not at ``shard_specs``'s placement raise: the
    whole query or pool where the heads split, a shard where they
    replicate."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention_sharded)
    rules = sharding.serve_exact_rules()
    q = torch.zeros((2, 8, 1, 16))
    kv = torch.zeros((6, 4, 4, 16))
    bt = torch.zeros((2, 3), dtype=torch.int32)
    lengths = torch.ones((2,), dtype=torch.int32)
    for at, qh, kvh in ((_ShardAt(1, 2, 0, 0), 8, 4),    # split: whole
                        (_ShardAt(1, 2, 0, 0), 4, 4),    # whole pool
                        (_ShardAt(1, 8, 0, 0), 1, 4)):   # replicated
        with pytest.raises(ValueError, match="placement gives"):
            paged_attention_sharded(q[:, :qh], kv[:, :kvh], kv[:, :kvh],
                                    bt, lengths, at, rules, n_heads=8,
                                    n_kv_heads=4)


@pytest.mark.parametrize("tp", [2, 4])
def test_fused_linear_acam_column_shards_match(tp):
    """Kernel B's plain version on each column shard of a weight,
    programmed against the whole weight's largest magnitude, equals the
    unsharded call's columns bitwise."""
    import numpy as np
    from repro_torch.kernels.dual_compute.ops import fused_linear_acam
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(6, 64)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(64, 128)) * 0.125, dtype=torch.float32)
    full = fused_linear_acam(x, w, "silu")
    w_max = torch.amax(torch.abs(w))
    n = 128 // tp
    for i in range(tp):
        cols = slice(i * n, (i + 1) * n)
        got = fused_linear_acam(x, w[:, cols].contiguous(), "silu",
                                w_max=w_max)
        assert torch.equal(got, full[:, cols])
