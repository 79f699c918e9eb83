"""Training on a mesh in the port equals single-device training
(``launch.train.build_train_step(mesh=, rules=)``, gloo ranks through
``launch.mesh.run_ranks``), at reduced ``qwen2_5_3b`` and Qwen3-MoE in
float32, with ``repro``'s own seeded weights (``convert.from_jax``).

Each mesh shape spawns its ranks once and runs every case of that shape:

* ``train`` at (2, 1), (1, 2) and (2, 2) and ``train_fsdp`` at (2, 1) and
  (2, 2): two AdamW steps held against the port's single-device step on
  the same weights and batch — the losses and grad norms within
  ``RTOL``, the first step's gathered gradients within ``GRAD_TOL`` of the
  leaf's largest (the second step's within ``GRAD_TOL_LATER``: they are
  taken at parameters that already differ within the Adam rule below, by
  up to 5e-5 at lr 1e-3), the gathered parameters within ``PARAM_TOL``
  times the learning rate where the single-device gradient reaches
  ``GRAD_FLOOR`` (the train tests' Adam rule: Adam divides a gradient by
  its own magnitude), and
  every leaf bitwise equal on the ranks that hold the same shard of it
  (replicated leaves cannot drift apart unnoticed);
* the (2, 2) ``train`` step directly against ``repro``'s jitted
  single-device step (the same tolerances);
* reduced Qwen3-MoE at capacity 1.0 on (2, 1): its routing groups follow
  the batch shards, so it equals the single-device step with
  ``batch_groups=2`` and ``repro``'s jitted one; assignments drop, and
  the step counts them under the gradient (``metrics["moe_dropped"]``),
  once though each layer is recomputed in the backward pass;
* a crossbar-NAF step on (1, 2): each rank's noisy run copy is the
  single-device one's slice bit for bit, and the step equals the
  single-device step;
* at (1, 2) under ``train`` and (2, 1) under ``train_fsdp``, a step with
  each layer recomputed gives the same parameters bit for bit when
  autograd runs the backward pass on a thread of its own, as it does for
  CUDA tensors (the sharding context is per thread).

The spawned ranks import this module to find their functions, so jax and
``repro`` are imported inside the test functions only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.drift import flatten
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import run_ranks, serve_mesh
from repro_torch.optim import adamw

torch.set_num_threads(1)

RTOL = 1e-5               # loss and grad norm
GRAD_TOL = 1e-5           # of each leaf's largest gradient (first step)
GRAD_TOL_LATER = 1e-4     # later steps: taken at parameters that differ
PARAM_TOL = 0.1           # times the learning rate ...
GRAD_FLOOR = 1e-6         # ... where the gradient reaches this
CLI_RTOL = 1e-3          # the bf16 train CLI's later losses
LR = 1e-3
STEPS = 2
DENSE, MOE = "qwen2_5_3b", "qwen3_moe_30b_a3b"

# mesh shape -> [(case, arch, rules, options)]
CASES = {
    (2, 1): [("train", DENSE, "train", {}),
             ("fsdp", DENSE, "train_fsdp", {}),
             ("moe", MOE, "train", {"batch_groups": 2})],
    (1, 2): [("train", DENSE, "train", {}),
             ("naf", DENSE, "train", {"naf": True})],
    (2, 2): [("train", DENSE, "train", {}),
             ("fsdp", DENSE, "train_fsdp", {})],
}
# the cases also held directly against repro's jitted step
AGAINST_REPRO = {((2, 2), "train"), ((2, 1), "moe")}


def _cfg(arch):
    """The reduced config at float32; the MoE one at capacity 1.0 (one
    slot per expert and group at least), so assignments drop, with each
    layer recomputed in the backward pass, as the full configs train (its
    drops count once)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              activation_dtype=torch.float32)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, scan_remat=True,
                                  moe=dataclasses.replace(
                                      cfg.moe, capacity_factor=1.0,
                                      min_capacity=1))
    return cfg


def _batch(cfg, step, b=4, s=12):
    rng = np.random.default_rng(100 + step)
    t = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}


def _np(tree) -> dict:
    return {"/".join(p): t.detach().numpy().copy() for p, t in flatten(tree)}


def _steps(step, params, opt, cfg, mesh=None):
    """``STEPS`` steps: per step the loss, grad norm, drops and the
    gathered gradients (``adamw.update`` wrapped to see them); then the
    gathered parameters and this rank's own shards."""
    from repro_torch.nn.module import gather_tree
    seen = {}
    update = adamw.update

    def keep(opt_cfg, grads, state, p, specs=None, mesh=None):
        seen["g"] = grads
        return update(opt_cfg, grads, state, p, specs=specs, mesh=mesh)

    out = []
    adamw.update = keep
    try:
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, i).items()}
            params, opt, m = step(params, opt, batch)
            g = seen.pop("g")
            if mesh is not None:
                g = gather_tree(g, step.specs, mesh)
            out.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "drops": (m["moe_dropped"].tolist()
                                  if "moe_dropped" in m else None),
                        "grads": _np(g)})
    finally:
        adamw.update = update
    full = params if mesh is None else gather_tree(params, step.specs, mesh)
    return out, _np(full), _np(params)


def _naf_run(cfg, params, specs=None, mesh=None):
    """The run copy of the first NAF step (``_NAFPass``), as numpy."""
    from repro_torch.launch import prng
    key = prng.fold_in(prng.prng_key(17), torch.zeros((), dtype=torch.int32))
    p = train_lib._NAFPass(key, params, lambda w: torch.float32, specs, mesh)
    out = {}
    for (path, _), leaf in zip(p.leaves, p.run):
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        out["/".join(path)] = t.detach().numpy().copy()
    return out


def _rank(shape, weights: dict, device):
    from repro_torch.nn.module import shard_tree
    mesh = serve_mesh(*shape, device)
    res = {"coords": mesh.coords}
    for name, arch, rules, opts in CASES[shape]:
        cfg = _cfg(arch)
        step = train_lib.build_train_step(
            cfg, adamw.AdamWConfig(lr=LR), mesh=mesh, rules=rules, **opts)
        params = _clone(shard_tree(from_jax(weights[arch], device="cpu"),
                                   step.specs, mesh))
        if opts.get("naf"):
            res["naf_run"] = _naf_run(cfg, params, step.specs, mesh)
        out, full, own = _steps(step, params, adamw.init(params), cfg, mesh)
        res[name] = {"steps": out, "params": full, "own": own,
                     "split": {"/".join(p): sorted(
                         {a for d in range(len(sp)) for a in sp.axes_of(d)})
                         for p, sp in flatten(step.specs)}}
    if shape in ON_A_THREAD:
        res["on_a_thread"] = _backward_on_a_thread(shape, weights, mesh)
    return res


# mesh shape -> the rule table whose step also runs with each layer
# recomputed and autograd's backward on a thread of its own
ON_A_THREAD = {(1, 2): "train", (2, 1): "train_fsdp"}


def _backward_on_a_thread(shape, weights, mesh):
    """One step of reduced ``qwen2_5_3b`` with every layer recomputed in
    the backward pass (``scan_remat``), with ``backward`` on this thread
    and then on a thread of its own, as autograd runs it for CUDA tensors
    (the sharding context is per thread; the recompute must reinstall
    it): the two steps' losses and parameters, gathered."""
    import threading

    from repro_torch.nn.module import gather_tree, shard_tree
    cfg = dataclasses.replace(_cfg(DENSE), scan_remat=True)
    step = train_lib.build_train_step(cfg, adamw.AdamWConfig(lr=LR),
                                      mesh=mesh, rules=ON_A_THREAD[shape])
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    here = torch.Tensor.backward

    def elsewhere(self, *args, **kw):
        err = []

        def run():
            try:
                here(self, *args, **kw)
            except BaseException as e:      # re-raised on this thread
                err.append(e)
        t = threading.Thread(target=run)
        t.start()
        t.join()
        if err:
            raise err[0]

    out = []
    for backward in (here, elsewhere):
        params = _clone(shard_tree(from_jax(weights[DENSE], device="cpu"),
                                   step.specs, mesh))
        torch.Tensor.backward = backward
        try:
            params, _, m = step(params, adamw.init(params), batch)
        finally:
            torch.Tensor.backward = here
        out.append((float(m["loss"]),
                    _np(gather_tree(params, step.specs, mesh))))
    return out


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    return t.clone()


_WEIGHTS = {}


def _weights(arch):
    """``repro``'s seeded init of ``arch`` at float32 (numpy leaves)."""
    if arch not in _WEIGHTS:
        import jax
        import jax.numpy as jnp
        from repro.configs import get_config as j_get_config
        from repro.models import lm as j_lm
        from repro.nn.module import param_dtype
        jc = j_get_config(arch, reduced=True)
        if jc.moe is not None:
            jc = dataclasses.replace(jc, moe=dataclasses.replace(
                jc.moe, capacity_factor=1.0, min_capacity=1))
        with param_dtype(jnp.float32):
            _WEIGHTS[arch] = jax.tree.map(
                np.asarray, j_lm.init_params(jax.random.key(0), jc))
    return _WEIGHTS[arch]


def _single(arch, **opts):
    cfg = _cfg(arch)
    step = train_lib.build_train_step(cfg, adamw.AdamWConfig(lr=LR), **opts)
    params = from_jax(_weights(arch), device="cpu")
    return _steps(step, params, adamw.init(params), cfg)


def _forward_drops(arch, batch_groups):
    """The first step's MoE drops from one single-device forward without
    recompute."""
    from repro_torch.models import lm
    cfg = dataclasses.replace(_cfg(arch), scan_remat=False)
    drops = torch.zeros(2, dtype=torch.int64)
    with torch.no_grad():
        lm.forward(from_jax(_weights(arch), device="cpu"),
                   torch.from_numpy(_batch(cfg, 0)["tokens"]), cfg,
                   mode="train", batch_groups=batch_groups, moe_drops=drops)
    return drops.tolist()


def _repro_steps(arch, batch_groups=1):
    """``repro``'s jitted single-device step, ``STEPS`` times: per step the
    loss and grad norm; then the parameters."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.launch.train import build_train_step as j_build
    from repro.optim import adamw as j_adamw
    jc = dataclasses.replace(j_get_config(arch, reduced=True),
                             activation_dtype=jnp.float32)
    if jc.moe is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=1.0, min_capacity=1))
    step = jax.jit(j_build(jc, j_adamw.AdamWConfig(lr=LR),
                           batch_groups=batch_groups))
    params = jax.tree.map(jnp.asarray, _weights(arch))
    opt = j_adamw.init(params)
    out = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in _batch(_cfg(arch), i).items()}
        params, opt, m = step(params, opt, batch)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return out, {"/".join(k.key for k in path): np.asarray(v)
                 for path, v in flat}


def _close(got_steps, got_params, want_steps, want_params, grads=None,
           what=""):
    for i, (g, w) in enumerate(zip(got_steps, want_steps)):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= RTOL * abs(w[k]), (what, i, k, g[k],
                                                          w[k])
        if "grads" in w:
            tol = GRAD_TOL if i == 0 else GRAD_TOL_LATER
            for leaf, want in w["grads"].items():
                err = np.max(np.abs(g["grads"][leaf] - want))
                assert err <= tol * max(np.max(np.abs(want)), 1e-30), \
                    (what, i, leaf, err)
    last = (grads or want_steps[-1].get("grads")) or {}
    for leaf, want in want_params.items():
        diff = np.abs(got_params[leaf] - want)
        mask = (np.abs(last[leaf]) >= GRAD_FLOOR if leaf in last
                else np.ones_like(want, bool))
        assert np.all(diff[mask] <= PARAM_TOL * LR), (what, leaf,
                                                      diff[mask].max())


def _replicas_equal(ranks, name, shape):
    """Every leaf is bitwise equal on the ranks that hold the same shard
    of it (those whose coordinates agree on the axes it is split on)."""
    res0 = ranks[0][name]
    for leaf, axes in res0["split"].items():
        groups: dict = {}
        for r in ranks:
            key = tuple(r["coords"][a] for a in axes)
            groups.setdefault(key, []).append(r[name]["own"][leaf])
        for key, copies in groups.items():
            for c in copies[1:]:
                assert np.array_equal(c, copies[0]), (shape, name, leaf, key)
        # a leaf replicated over a mesh axis of size > 1 has copies
    assert any(len(set(axes)) < len(shape) for axes in
               res0["split"].values())


@pytest.mark.parametrize("shape", list(CASES), ids=str)
def test_sharded_train_step_equals_single_device(shape):
    weights = {arch: _weights(arch) for _, arch, _, _ in CASES[shape]}
    ranks = run_ranks(_rank, shape[0] * shape[1], (shape, weights))
    single = {}
    for name, arch, rules, opts in CASES[shape]:
        single_opts = {k: v for k, v in opts.items()}
        key = (arch, tuple(sorted(single_opts.items())))
        if key not in single:
            single[key] = _single(arch, **single_opts)
        w_steps, w_params, _ = single[key]
        for r in ranks:
            got = r[name]
            _close(got["steps"], got["params"], w_steps, w_params,
                   what=(shape, name))
        _replicas_equal(ranks, name, shape)
        if name == "moe":
            drops = [s["drops"] for s in ranks[0][name]["steps"]]
            assert drops == [s["drops"] for s in w_steps]
            assert drops[0][0] > 0          # capacity 1.0 drops
            # counted once, though the backward pass recomputes each layer
            assert drops[0] == _forward_drops(arch, opts["batch_groups"])
        if (shape, name) in AGAINST_REPRO:
            # repro's jitted single-device step with the same groups (the
            # parameters' mask reads the port's single-device gradients)
            j_steps, j_params = _repro_steps(arch, opts.get(
                "batch_groups", 1))
            for r in ranks:
                _close(r[name]["steps"], r[name]["params"], j_steps,
                       j_params, grads=w_steps[-1]["grads"],
                       what=(shape, name, "repro"))
    if shape in ON_A_THREAD:
        for r in ranks:
            (loss, want), (got_loss, got) = r["on_a_thread"]
            assert got_loss == loss
            for leaf in want:
                np.testing.assert_array_equal(got[leaf], want[leaf],
                                              err_msg=leaf)
    if shape == (1, 2):
        # NAF: each rank's noise is the single-device draw's slice
        cfg = _cfg(DENSE)
        want = _naf_run(cfg, from_jax(_weights(DENSE), device="cpu"))
        for r in ranks:
            for leaf, got in r["naf_run"].items():
                axes = r["naf"]["split"][leaf]
                view = _View({"data": shape[0], "model": shape[1]},
                             r["coords"])
                sp = _leaf_spec(leaf, cfg, shape)
                np.testing.assert_array_equal(
                    got, sp.local(torch.from_numpy(want[leaf]), view).numpy(),
                    err_msg=leaf)
                assert axes == sorted({a for d in range(len(sp))
                                       for a in sp.axes_of(d)})


class _View:
    """A picklable mesh view (``Spec.local`` reads ``shape``/``coords``)."""

    def __init__(self, shape, coords):
        self.shape, self.coords = dict(shape), dict(coords)


def _leaf_spec(leaf, cfg, shape):
    from repro_torch.models import lm
    from repro_torch.nn.module import spec_tree
    from repro_torch.parallel.sharding import train_rules
    specs = dict(flatten(spec_tree(lm.param_shapes(cfg), cfg,
                                   _View({"data": shape[0],
                                          "model": shape[1]},
                                         {"data": 0, "model": 0}),
                                   train_rules())))
    return specs[tuple(leaf.split("/"))]


def test_train_mesh_refusals():
    """What does not train on a mesh yet raises, naming ROADMAP: FUSED
    numerics (kernels B and C have no backward), recurrent and RWKV6
    blocks (A.2 queue, item 3), on the step and on the CLI; kv heads
    replicated over "model" (item 5); an unknown train table;
    ``--mesh-rules`` without ``--mesh``."""
    from repro_torch.core.engine import FUSED
    from repro_torch.launch.mesh import single_device_mesh
    one = single_device_mesh()
    opt = adamw.AdamWConfig()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A"):
        train_lib.build_train_step(_cfg(DENSE), opt, nldpe=FUSED, mesh=one)
    for arch in ("recurrentgemma_9b", "rwkv6_3b"):
        with pytest.raises(NotImplementedError, match="item 3"):
            train_lib.build_train_step(get_config(arch, reduced=True), opt,
                                       mesh=one)
        with pytest.raises(SystemExit):
            train_lib.run(["--arch", arch, "--mesh", "1,2", "--device",
                           "cpu"])
    with pytest.raises(ValueError, match="train rule table"):
        train_lib.build_train_step(_cfg(DENSE), opt, mesh=one, rules="serve")
    with pytest.raises(SystemExit):
        train_lib.run(["--mesh-rules", "train", "--device", "cpu"])
    # batch groups train (the refusal is gone)
    step = train_lib.build_train_step(_cfg(MOE), opt, batch_groups=2)
    assert step.specs is None
    # 2 kv heads over a "model" axis of 4: the query heads would gather
    # and the replicated K/V take partial gradients (item 5); refused
    # before any collective, so a mesh view without process groups shows
    # it
    from repro_torch.models import lm
    from repro_torch.nn.attention import attn_apply
    from repro_torch.nn.module import shard_tree, spec_tree
    from repro_torch.parallel.context import Mesh, sharding_ctx
    from repro_torch.parallel.sharding import train_rules
    cfg, four = _cfg(DENSE), Mesh(shape={"data": 1, "model": 4})
    params = lm.init_params(cfg, device="cpu")
    local = shard_tree(params, spec_tree(params, cfg, four, train_rules()),
                       four)
    layer = lm._index(local["groups"]["b0"], 0)
    with sharding_ctx(four, train_rules()):
        with pytest.raises(NotImplementedError, match="item 5"):
            attn_apply(layer["attn"], lm.attn_spec(cfg),
                       torch.zeros((1, 4, cfg.d_model)),
                       positions=torch.arange(4)[None], mode="train")


def test_train_cli_on_a_mesh_prints_the_unsharded_losses():
    """``--mesh 2,2`` spawns its gloo ranks; rank 0's losses are the
    command's without ``--mesh``: the first within ``RTOL``, the later
    ones within ``CLI_RTOL`` (the CLI computes in bf16, where each batch
    shard's gradient rounds to bf16 before the shards are summed)."""
    argv = ["--arch", DENSE, "--steps", "3", "--batch", "4", "--seq", "8",
            "--device", "cpu"]
    want = train_lib.run(argv)
    got = train_lib.run(argv + ["--mesh", "2,2", "--mesh-rules",
                                "train_fsdp"])
    assert len(got) == len(want)
    assert abs(got[0] - want[0]) <= RTOL * abs(want[0])
    for a, b in zip(got, want):
        assert abs(a - b) <= CLI_RTOL * abs(b)
