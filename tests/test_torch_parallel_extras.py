"""The port's gradient compression, elastic resharding, pipeline and
expert-parallel MoE (``parallel/compression.py``, ``checkpoint/
reshard.py``, ``parallel/pipeline.py``, ``nn/moe_ep.py``) held against
``repro`` on the CPU, the multi-rank ones on gloo ranks
(``launch.mesh.run_ranks``).

* compression: bitwise against ``repro``'s eager ``compress`` and
  ``ef_compress_step`` on seeded trees; the port divides as eager
  ``repro`` does (true IEEE divisions, not ``scalar_div``'s reciprocal
  product, which ``jit`` would fuse — ROADMAP C's KV-grid rule);
* reshard: two train steps on (1, 2), a mesh-aware save (gathered, rank 0
  writes), a restore onto (2, 1): the restored leaves equal the gathered
  saved ones and two more steps equal the same steps from the in-memory
  state, bit for bit;
* pipeline: 4 ranks on "pod": the forward equals ``repro``'s test's
  sequential body, the gradients of ``pipeline_loss`` ``jax.grad`` of the
  sequential loss (``PIPE_TOL``), ``bubble_fraction`` ``repro``'s;
* moe_ep: 8 ranks at (2, 4): dropless against ``repro``'s dense
  ``moe_apply`` (``repro``'s own 2e-3, and ``EP_TOL``), the capacity mode
  finite.

The spawned ranks import this module to find their functions, so jax and
``repro`` are imported inside the test functions only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_mesh, run_ranks

torch.set_num_threads(1)

PIPE_TOL = 1e-5
EP_TOL = 1e-5
K, M, D = 4, 6, 16              # pipeline: stages, microbatches, width


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((64, 32)) * scale).astype(np.float32),
            "b": {"x": (rng.standard_normal(17) * 1e-3).astype(np.float32),
                  "z": np.zeros(5, np.float32)}}


def test_compression_matches_repro_bitwise():
    import jax
    import jax.numpy as jnp
    from repro.parallel import compression as jc

    from repro_torch.parallel import compression as tc
    rng = np.random.default_rng(0)
    for scale in (1.0, 3e-7, 40.0):
        tree = _tree(rng, scale)
        for leaf in jax.tree.leaves(tree):
            jq, js = jc.compress(jnp.asarray(leaf))
            tq, ts = tc.compress(torch.from_numpy(leaf))
            np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
            assert np.float32(js) == ts.numpy()
            np.testing.assert_array_equal(
                np.asarray(jc.decompress(jq, js)),
                tc.decompress(tq, ts).numpy())
    # three error-feedback steps on a changing gradient
    j_err = t_err = None
    for step in range(3):
        g = _tree(np.random.default_rng(step + 1))
        jw, jr, j_err = jc.ef_compress_step(
            jax.tree.map(jnp.asarray, g), j_err)
        tw, tr, t_err = tc.ef_compress_step(
            {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                 {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in g.items()}, t_err)
        for path in (("w",), ("b", "x"), ("b", "z")):
            def at(t):
                for k in path:
                    t = t[k]
                return t
            np.testing.assert_array_equal(np.asarray(at(jw)[0]),
                                          at(tw)[0].numpy())
            assert np.float32(at(jw)[1]) == at(tw)[1].numpy()
            np.testing.assert_array_equal(np.asarray(at(jr)),
                                          at(tr).numpy())
            np.testing.assert_array_equal(np.asarray(at(j_err)),
                                          at(t_err).numpy())
    assert tc.bytes_scale() == float(jc.bytes_scale()) == 0.25
    assert tc.bytes_scale(torch.bfloat16) == float(
        jc.bytes_scale(jnp.bfloat16)) == 0.5


# ---------------------------------------------------------------------------
# reshard: train on (1, 2), save, restore onto (2, 1), continue
# ---------------------------------------------------------------------------

def _train_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                               activation_dtype=torch.float32)


def _train_batch(cfg, step):
    g = torch.Generator().manual_seed(100 + step)
    t = torch.randint(0, cfg.vocab_size, (4, 9), generator=g).to(torch.int32)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def _np_tree(tree):
    from repro_torch.core.drift import flatten
    return {"/".join(p): t.detach().numpy().copy() for p, t in flatten(tree)}


def _reshard_rank(shape, phase, ckpt, device):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import build_train_step, state_specs
    from repro_torch.models import lm
    from repro_torch.nn.module import gather_tree, shard_tree
    from repro_torch.optim import adamw
    cfg = _train_cfg()
    mesh = make_mesh(shape, ("data", "model"))
    step = build_train_step(cfg, adamw.AdamWConfig(lr=1e-3), mesh=mesh)
    specs = state_specs(step.specs)
    man = CheckpointManager(ckpt)
    if phase == "save":
        params = _clone(shard_tree(lm.init_params(cfg, device="cpu"),
                                   step.specs, mesh))
        opt = adamw.init(params)
        for i in range(2):
            params, opt, _ = step(params, opt, _train_batch(cfg, i))
        state = {"params": params, "opt": opt}
        man.save(state, 2, specs=specs, mesh=mesh)
        return _np_tree(gather_tree(state, specs, mesh))
    # restore the (1, 2) state onto this mesh and continue
    tmpl = shard_tree(lm.init_params(cfg, device="cpu"), step.specs, mesh)
    tmpl = {"params": tmpl, "opt": adamw.init(tmpl)}
    state, at = man.restore_latest(tmpl, specs=specs, mesh=mesh)
    restored = _np_tree(gather_tree(state, specs, mesh))
    params, opt = state["params"], state["opt"]
    for i in range(2, 4):
        params, opt, _ = step(params, opt, _train_batch(cfg, i))
    return at, restored, _np_tree(gather_tree({"params": params,
                                               "opt": opt}, specs, mesh))


def _resume_rank(shape, saved, device):
    """The same two steps on ``shape`` from the in-memory (gathered) state
    of the (1, 2) run."""
    from repro_torch.launch.train import build_train_step, state_specs
    from repro_torch.nn.module import gather_tree
    from repro_torch.checkpoint.reshard import reshard_tree
    from repro_torch.optim import adamw
    cfg = _train_cfg()
    mesh = make_mesh(shape, ("data", "model"))
    step = build_train_step(cfg, adamw.AdamWConfig(lr=1e-3), mesh=mesh)
    specs = state_specs(step.specs)
    state = _from_np(saved)
    state = reshard_tree(state, specs, mesh)
    params, opt = state["params"], state["opt"]
    for i in range(2, 4):
        params, opt, _ = step(params, opt, _train_batch(cfg, i))
    return _np_tree(gather_tree({"params": params, "opt": opt}, specs,
                                mesh))


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    return t.clone()


def _from_np(flat: dict) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(arr.copy())
    return out


def test_reshard_restores_onto_another_mesh_and_continues(tmp_path):
    saved = run_ranks(_reshard_rank, 2, ((1, 2), "save", str(tmp_path)))[0]
    got = run_ranks(_reshard_rank, 2, ((2, 1), "load", str(tmp_path)))
    want = run_ranks(_resume_rank, 2, ((2, 1), saved))[0]
    for at, restored, cont in got:
        assert at == 2
        assert set(restored) == set(saved)
        for k in saved:
            np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
            np.testing.assert_array_equal(cont[k], want[k], err_msg=k)
    # the continued state moved
    assert any(not np.array_equal(want[k], saved[k]) for k in saved
               if k.startswith("params"))


def test_reshard_and_replicate_tree_on_one_rank():
    from repro_torch.checkpoint.reshard import reshard_tree, replicate_tree
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.parallel.context import Mesh
    from repro_torch.parallel.sharding import Spec
    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.arange(4.0)}
    one = single_device_mesh()
    out = reshard_tree(tree, {"w": Spec(("data", "model")), "b": Spec()},
                       one)
    assert torch.equal(out["w"], tree["w"]) and out["b"] is tree["b"]
    # rank 5 of a (4, 2) view: rows 4..5, columns 4..7
    view = Mesh(shape={"data": 4, "model": 2}, rank=5)
    out = reshard_tree(tree, {"w": Spec(("data", "model")), "b": Spec()},
                       view)
    assert torch.equal(out["w"], tree["w"][4:6, 4:8])
    rep = replicate_tree(tree, one)
    assert torch.equal(rep["w"], tree["w"]) and rep["w"] is not tree["w"]


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def _pipe_data():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((K, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, 2, D)).astype(np.float32)
    y = rng.standard_normal((M, 2, D)).astype(np.float32)
    return w, x, y


def _body(p, h):
    return torch.tanh(h @ p["w"])


def _mse(o, y):
    return torch.mean((o - y) ** 2)


def _pipe_rank(device):
    from repro_torch.parallel.pipeline import pipeline_forward, pipeline_loss
    mesh = make_mesh((K,), ("pod",))
    w, x, y = (torch.from_numpy(a) for a in _pipe_data())
    s = mesh.coords["pod"]
    with torch.no_grad():
        out = pipeline_forward({"w": w[s:s + 1]}, x, _body, mesh)
    mine = w[s:s + 1].clone().requires_grad_()
    loss = pipeline_loss({"w": mine}, x, y, _body, _mse, mesh)
    loss.backward()
    return out.numpy(), float(loss), mine.grad[0].numpy()


def test_pipeline_matches_sequential_and_jax_grad():
    import jax
    import jax.numpy as jnp
    from repro.parallel.pipeline import bubble_fraction as j_bubble

    from repro_torch.parallel.pipeline import bubble_fraction
    w, x, y = _pipe_data()

    def seq(ws):
        h = jnp.asarray(x)
        for s in range(K):
            h = jnp.tanh(h @ ws[s])         # repro's test's body
        return h

    ref = np.asarray(seq(jnp.asarray(w)))
    loss, grad = jax.value_and_grad(
        lambda ws: jnp.mean((seq(ws) - jnp.asarray(y)) ** 2))(jnp.asarray(w))
    got = run_ranks(_pipe_rank, K, ())
    for s, (out, lv, g) in enumerate(got):
        np.testing.assert_allclose(out, ref, rtol=0, atol=PIPE_TOL)
        assert abs(lv - float(loss)) <= PIPE_TOL * abs(float(loss))
        np.testing.assert_allclose(g, np.asarray(grad[s]), rtol=0,
                                   atol=PIPE_TOL)
    for m, k in ((M, K), (1, 4), (16, 2), (3, 1)):
        assert bubble_fraction(m, k) == j_bubble(m, k)
    assert 0 < bubble_fraction(M, K) < 1


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

def _ep_rank(p_np, x_np, cf, device):
    from repro_torch.nn.moe import MoESpec
    from repro_torch.nn.moe_ep import moe_apply_ep
    from repro_torch.parallel.sharding import Spec
    mesh = make_mesh((2, 4), ("data", "model"))
    spec = MoESpec(n_experts=8, top_k=2, d_expert_ff=16, capacity_factor=cf)
    experts = Spec(("model",))
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    p = {k: (v if k == "router" else experts.local(v, mesh).contiguous())
         for k, v in p.items()}
    x = Spec(("data",)).local(torch.from_numpy(x_np), mesh)
    return moe_apply_ep(p, x, spec, mesh).numpy()


def test_moe_ep_matches_repro_dense_moe():
    import jax
    from repro.nn import moe as jm

    spec = jm.MoESpec(n_experts=8, top_k=2, d_expert_ff=16,
                      capacity_factor=0.0)
    d = 32
    p = jax.tree.map(np.asarray, jm.moe_init(jax.random.key(0), d, spec))
    x = np.asarray(jax.random.normal(jax.random.key(1), (4, 8, d)),
                   np.float32)
    ref = np.asarray(jm.moe_apply(jax.tree.map(jax.numpy.asarray, p),
                                  jax.numpy.asarray(x), spec))
    got = run_ranks(_ep_rank, 8, (p, x, 0.0))
    for r, out in enumerate(got):
        rows = slice((r // 4) * 2, (r // 4) * 2 + 2)   # data coordinate
        np.testing.assert_allclose(out, ref[rows], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(out, ref[rows], rtol=0, atol=EP_TOL)
    capped = run_ranks(_ep_rank, 8, (p, x, 1.25))
    assert all(np.all(np.isfinite(c)) for c in capped)
