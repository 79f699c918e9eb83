"""Training the windowed, recurrent, MoE and RWKV6 block types in the
port (``launch/train.py`` over every pattern, the band, the RG-LRU scan,
the MoE dispatch and combine and the chunked WKV under autograd), held
against ``repro``'s train step on the CPU at the reduced ``gemma3_27b``
(1 x 6 + a 2-layer tail), ``recurrentgemma_9b``, ``qwen3_moe_30b_a3b``
(dropless and at capacity factor 1.0), ``llama4_scout_17b_a16e`` and
``rwkv6_3b``, in float32, with ``repro``'s own seeded weights
(``convert.from_jax``); the train CLI's restart and ``train_lm_100m``.

Tolerances (``tests/test_torch_train.py``'s, unless named here):

* the loss within ``LOSS_RTOL``, the grad norm within ``GN_RTOL``, the
  first moments within ``M_TOL`` (gradient sums in another order);
* the second moments within ``V_TOL`` or, where larger, ``V_RTOL`` of
  the leaf's largest: v = (1 - b2) g^2 scales with the gradient's square,
  and these models' grad norms run to 32 against ~3 there; RWKV6's
  gradients carry XLA's ``cumsum`` order through the centred decay
  exponentials (``tests/test_torch_rwkv6.py`` holds its time-mix at 1e-5
  of the largest magnitude), which the square doubles;
* the parameters within ``PARAM_TOL`` times the learning rate wherever
  the reference gradient reaches ``G_FLOOR``: Adam's first step moves a
  parameter by lr g / (|g| + 1e-8), so a gradient of a few 1e-9 (0.1% of
  its leaf's largest) that differs by its summation order moves its
  update by up to lr (measured: 4.4e-9 against 8.7e-9 on RecurrentGemma's
  MLP); ``M_TOL`` holds those gradients everywhere;
* the tie rules of ``jnp.clip``/``jnp.maximum`` (half the gradient at a
  tie) and of ``jax.nn.softplus`` (0.5 at 0) at ``TIE_TOL``;
* the NAF step on reduced Gemma3 runs ``repro``'s step eagerly: jitted,
  its 90 leaves' noise takes ~200 s of XLA compile.  Eager JAX divides
  by a scalar where ``jit`` multiplies by its reciprocal, which the port
  follows; the same tolerances hold.
"""
import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.train import build_train_step as j_build
from repro.models import lm as j_lm
from repro.nn import rglru as JR
from repro.nn import rwkv6 as JW
from repro.nn.module import param_dtype
from repro.optim import adamw as j_adamw

from repro_torch import train_lm_100m
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.drift import flatten
from repro_torch.launch.train import build_train_step, run
from repro_torch.models import lm
from repro_torch.nn import rglru, rwkv6
from repro_torch.optim import adamw

torch.set_num_threads(1)

LOSS_RTOL = 1e-6
GN_RTOL = 1e-5
M_TOL = 1e-7
V_TOL, V_RTOL = 1e-9, 2e-5
PARAM_TOL = 0.1           # times the learning rate
G_FLOOR = 1e-6            # 100 x Adam's eps
TIE_TOL = 1e-6
LR = 1e-3
DROPPING = dict(capacity_factor=1.0, min_capacity=2)
_PARAMS = {}


def cfgs(arch, **moe):
    ct = dataclasses.replace(get_config(arch, reduced=True),
                             activation_dtype=torch.float32)
    cj = dataclasses.replace(j_get_config(arch, reduced=True),
                             activation_dtype=jnp.float32)
    if moe:
        ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe, **moe))
        cj = dataclasses.replace(cj, moe=dataclasses.replace(cj.moe, **moe))
    return ct, cj


def j_params(arch):
    """``repro``'s seeded init of the reduced ``arch`` (numpy leaves)."""
    if arch not in _PARAMS:
        with param_dtype(jnp.float32):
            _PARAMS[arch] = jax.tree.map(np.asarray, jax.jit(partial(
                j_lm.init_params, cfg=cfgs(arch)[1]))(jax.random.key(5)))
    return _PARAMS[arch]


def _batch(b, s, seed):
    t = np.random.default_rng(seed).integers(0, 256, (b, s + 1)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])},
            {"tokens": torch.from_numpy(t[:, :-1].copy()),
             "labels": torch.from_numpy(t[:, 1:].copy())})


def _leaf_diff(a, b) -> np.ndarray:
    return np.abs(np.asarray(a) - b.detach().numpy())


def _step_matches(arch, ct, cj, *, naf=False, seq=24, seed=3):
    """One AdamW (or NAF) step of both packages from the same weights and
    batch, compared under the module docstring's tolerances."""
    jb, tb = _batch(2, seq, seed)
    kw = dict(naf=naf, naf_lambda1=1e-2, naf_lambda2=1e-2)
    jstep = j_build(cj, j_adamw.AdamWConfig(lr=LR), **kw)
    if not naf:
        jstep = jax.jit(jstep)
    pj = jax.tree.map(jnp.asarray, j_params(arch))
    pj2, sj, mj = jstep(pj, j_adamw.init(pj), jb)
    pt = from_jax(j_params(arch), device="cpu")
    st = adamw.init(pt)
    pt2, st2, mt = build_train_step(ct, adamw.AdamWConfig(lr=LR), **kw)(
        pt, st, tb)
    assert pt2 is pt and st2 is st                  # updated in place
    assert mt["loss"].item() == pytest.approx(float(mj["loss"]),
                                              rel=LOSS_RTOL)
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                   rel=GN_RTOL)
    assert int(st["step"]) == 1
    leaves = list(zip(jax.tree.leaves(pj2), jax.tree.leaves(sj["m"]),
                      jax.tree.leaves(sj["v"]), flatten(pt), flatten(st["m"]),
                      flatten(st["v"])))
    assert len(leaves) == len(flatten(pt))
    for p_ref, m_ref, v_ref, (path, p), (_, m), (_, v) in leaves:
        assert _leaf_diff(m_ref, m).max() <= M_TOL, path
        v_tol = max(V_TOL, V_RTOL * float(np.abs(np.asarray(v_ref)).max()))
        assert _leaf_diff(v_ref, v).max() <= v_tol, path
        live = np.abs(np.asarray(m_ref)) / 0.1 >= G_FLOOR   # m = 0.1 g
        assert (_leaf_diff(p_ref, p)[live].max(initial=0.0)
                <= PARAM_TOL * LR), path
    return pt


@pytest.mark.parametrize("arch,moe", [
    ("gemma3_27b", {}), ("recurrentgemma_9b", {}),
    ("qwen3_moe_30b_a3b", {}), ("qwen3_moe_30b_a3b", DROPPING),
    ("llama4_scout_17b_a16e", {}), ("rwkv6_3b", {})],
    ids=["gemma3", "recurrentgemma", "qwen3moe-dropless", "qwen3moe-drops",
         "llama4scout", "rwkv6"])
def test_train_step_matches_repro(arch, moe):
    """One AdamW step of each new pattern against ``repro``'s jitted step,
    24 positions: past the reduced windows (16), so the band trains."""
    ct, cj = cfgs(arch, **moe)
    _step_matches(arch, ct, cj)
    if moe:                     # the drops happen under the gradient
        drops = torch.zeros(2, dtype=torch.int64)
        lm.forward(from_jax(j_params(arch), device="cpu"),
                   _batch(2, 24, 3)[1]["tokens"], ct, mode="train",
                   moe_drops=drops)
        assert int(drops[0]) > 0


def test_naf_step_covers_the_tail_tree():
    """A crossbar-NAF step on reduced Gemma3 (a 2-layer tail beside the
    stacked group): one key per leaf in flatten order over ``tail`` too,
    and Eq 8's arg-maxes across the whole tree, against ``repro``'s step
    (eager; the module docstring)."""
    ct, cj = cfgs("gemma3_27b")
    pt = _step_matches("gemma3_27b", ct, cj, naf=True)
    assert "tail" in pt and len(pt["tail"]) == 2


def test_train_step_frees_its_trees_without_the_cycle_collector(
        monkeypatch):
    """Once a step has returned and its trees are dropped, the masters,
    the moments and the gradients are freed at once: a nested recursion in
    ``flatten``/``unflatten`` held every leaf in a reference cycle until
    the cyclic collector ran (on the card, 60 GB of a train phase's state
    outlived it)."""
    import gc
    import weakref

    import repro_torch.launch.train as T
    ct, _ = cfgs("qwen3_moe_30b_a3b")
    grads = []
    update = T.adamw.update

    def spy(cfg, g, state, params, **kw):
        grads.append(weakref.ref(flatten(g)[0][1]))
        return update(cfg, g, state, params, **kw)
    monkeypatch.setattr(T.adamw, "update", spy)
    pt = from_jax(j_params("qwen3_moe_30b_a3b"), device="cpu")
    st = adamw.init(pt)
    refs = [weakref.ref(flatten(pt)[0][1]), weakref.ref(flatten(st["m"])[0][1])]
    gc.disable()
    try:
        out = build_train_step(ct, adamw.AdamWConfig(lr=LR))(
            pt, st, _batch(2, 8, 1)[1])
        del out, pt, st
        assert [r() for r in refs + grads] == [None] * 3
    finally:
        gc.enable()


@pytest.mark.parametrize("lam", [0.0, 0.7])
def test_rglru_gates_differentiate_like_repro(lam):
    """``softplus``'s derivative at Lambda == 0 is ``jax``'s 0.5 (the
    max-plus-log1p form differentiates to 1 there)."""
    rng = np.random.default_rng(1)
    d = 8
    p = {"w_a": rng.normal(size=(d, d)), "b_a": np.zeros(d),
         "w_x": rng.normal(size=(d, d)), "b_x": np.zeros(d),
         "lam": np.full(d, lam)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)

    def j_f(p):
        a, beta, i = JR._gates(p, jnp.asarray(x), JR.OFF)
        return jnp.sum(a) + jnp.sum(beta) + jnp.sum(i)
    ref = jax.grad(j_f)(jax.tree.map(jnp.asarray, p))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    a, beta, i = rglru._gates(tp, torch.from_numpy(x), rglru.OFF)
    (a.sum() + beta.sum() + i.sum()).backward()
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(ref[k]),
                                   rtol=TIE_TOL, atol=TIE_TOL)


@pytest.mark.parametrize("grad", [False, True], ids=["values", "under_grad"])
def test_rglru_softplus_keeps_the_clamp_values(grad):
    """The tie rule changes no value: ``softplus`` gives the
    max-plus-log1p form's float32 bits with and without a gradient (the
    serve paths are held bitwise; ``torch.logaddexp`` rounds 4% of
    these differently)."""
    x = torch.linspace(-100, 100, 200_001)
    x[::7] = 0.0
    want = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    got = rglru.softplus(x.clone().requires_grad_(grad)).detach()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_chunked_wkv_decay_clip_differentiates_like_repro():
    """A decay of exactly 1.0 (``exp(-exp(ww))`` for a very negative
    ``ww``) sits on the clip's upper bound: half the gradient goes
    through, as ``jnp.clip`` sends it."""
    rng = np.random.default_rng(2)
    b, h, s, n = 1, 1, 8, 64
    r, k, v = (rng.normal(size=(b, h, s, n)).astype(np.float32) * 0.3
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, size=(b, h, s, n)).astype(np.float32)
    w[..., ::3] = 1.0
    u = rng.normal(size=(h, n)).astype(np.float32) * 0.1
    s0 = np.zeros((b, h, n, n), np.float32)

    def j_f(w):
        out, st = JW._chunked_wkv(*map(jnp.asarray, (r, k, v)), w,
                                  jnp.asarray(u), jnp.asarray(s0), 4)
        return jnp.sum(out) + jnp.sum(st)
    ref = np.asarray(jax.grad(j_f)(jnp.asarray(w)))
    tw = torch.from_numpy(w).requires_grad_()
    out, st = rwkv6._chunked_wkv(*map(torch.from_numpy, (r, k, v)), tw,
                                 torch.from_numpy(u), torch.from_numpy(s0), 4)
    (out.sum() + st.sum()).backward()
    got = tw.grad.numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    tie = w == 1.0
    assert np.abs(got[tie]).max() > 0.1 * scale     # the ties carry weight


def test_cli_restart_bit_exact_on_gemma3(tmp_path, capsys):
    """``--arch gemma3_27b``: killed at step 7, resumed from the step-5
    checkpoint, the losses equal an uninterrupted run's bit for bit."""
    argv = ["--arch", "gemma3_27b", "--steps", "10", "--batch", "2",
            "--seq", "24", "--ckpt-every", "5", "--device", "cpu"]
    ck, clean_ck = str(tmp_path / "ck"), str(tmp_path / "clean")
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        run(argv + ["--ckpt-dir", ck, "--fail-at-step", "7"])
    assert CheckpointManager(ck).latest_step() == 5
    resumed = run(argv + ["--ckpt-dir", ck])
    assert "[train] restored checkpoint at step 5" in capsys.readouterr().out
    clean = run(argv + ["--ckpt-dir", clean_ck])
    assert len(resumed) == 5 and resumed == clean[5:]
    assert all(np.isfinite(clean))
    with np.load(os.path.join(ck, "step_10", "arrays.npz")) as x, \
            np.load(os.path.join(clean_ck, "step_10", "arrays.npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        for name in x.files:
            assert np.array_equal(x[name], y[name]), name


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "qwen3_moe_30b_a3b",
                                  "llama4_scout_17b_a16e", "rwkv6_3b"])
def test_cli_trains_every_arch(arch):
    """The train CLI takes every reduced arch: the loss falls over 12
    steps."""
    losses = run(["--arch", arch, "--steps", "12", "--batch", "4", "--seq",
                  "24", "--device", "cpu"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_lm_100m_runs_on_the_cpu(tmp_path):
    """``train_lm_100m`` at a few steps: the ~100 M config through
    ``build_train_step``, the WSD schedule, ``resilient_loop`` and the
    async ``CheckpointManager``; a second run resumes from its last
    checkpoint."""
    cfg = train_lm_100m.hundred_m_config()
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (8, 512, 4096)
    argv = ["--steps", "4", "--batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path), "--device", "cpu"]
    losses, report = train_lm_100m.main(argv)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(cfg.vocab_size)) < 1.0   # ~ln V
    assert report.completed_steps == 4 and report.restarts == 0
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    more, report = train_lm_100m.main(argv[:1] + ["6"] + argv[2:])
    assert len(more) == 2 and report.completed_steps == 2
