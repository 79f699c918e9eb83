"""The port's training path (``optim/``, ``data/synthetic.py``,
``models.lm.forward(mode="train")``/``lm_loss``, ``launch/train.py``,
``convert.from_jax`` of optimizer state and ACAM tables) held against
``repro`` on the CPU at reduced ``qwen2_5_3b`` and ``minicpm_2b`` in
float32, with ``repro``'s own seeded weights.

Tolerances and their causes:

* schedules, ``linf`` without smoothing, the batches' start tokens and
  keys: bitwise;  the schedules' ``cos``/``exp`` and ``logsumexp`` may
  round an ulp apart (``ULP_F32`` relative);
* batches: equal except after a Gumbel near-tie (the two logs of a Gumbel
  draw round an ulp apart; ROADMAP C), which the test reports;
* logits and losses: f32 matmul and softmax sums in another order
  (``LOGIT_TOL``, ``LOSS_RTOL``); under ``ON`` an 8-bit log-grid code may
  flip one LSB (ROADMAP.md: "Log-grid codes"), which moves every logit of
  the rows past it: at most ``ON_FLIP_SHARE`` of the rows, within
  ``ON_LOGIT_TOL``;
* one train step: the loss within ``LOSS_RTOL``, the moments within
  ``M_TOL``/``V_TOL`` (gradient sums in another order), the parameters
  within ``PARAM_TOL`` times the learning rate: Adam divides each
  gradient by its own magnitude, so a gradient of ~1e-9 that differs in
  its last bits moves its update by more than its relative error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import dt as j_dt
from repro.core.engine import NLDPEConfig as JNLDPEConfig
from repro.data import synthetic as j_synth
from repro.launch.train import build_train_step as j_build
from repro.models import lm as j_lm
from repro.nn.module import param_dtype
from repro.optim import adamw as j_adamw
from repro.optim import naf_loss as j_naf_loss
from repro.optim import schedules as j_sched

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core import dt
from repro_torch.core.drift import flatten
from repro_torch.core.engine import FUSED, NLDPEConfig
from repro_torch.data import synthetic
from repro_torch.launch.train import build_train_step, run
from repro_torch.models import lm
from repro_torch.optim import adamw, naf_loss, schedules

torch.set_num_threads(1)

ULP_F32 = 2.0 ** -23
LOGIT_TOL = 1e-5
ON_LOGIT_TOL = 1e-2       # a position past a one-LSB log-grid code flip
ON_FLIP_SHARE = 0.05      # of the (batch, position) rows
LOSS_RTOL = 1e-6
M_TOL, V_TOL = 1e-7, 1e-9
PARAM_TOL = 0.1           # times the learning rate
ARCHS = ("qwen2_5_3b", "minicpm_2b")
_PARAMS = {}


def _cfgs(arch):
    return (dataclasses.replace(j_get_config(arch, reduced=True),
                                activation_dtype=jnp.float32),
            dataclasses.replace(get_config(arch, reduced=True),
                                activation_dtype=torch.float32))


def _params(arch):
    """``repro``'s seeded init of ``arch`` (numpy leaves) and the port's
    float32 copy."""
    if arch not in _PARAMS:
        cj, _ = _cfgs(arch)
        with param_dtype(jnp.float32):
            _PARAMS[arch] = jax.tree.map(
                np.asarray, j_lm.init_params(jax.random.key(0), cj))
    pj = _PARAMS[arch]
    return jax.tree.map(jnp.asarray, pj), from_jax(pj, device="cpu")


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])},
            {"tokens": torch.from_numpy(t[:, :-1].copy()),
             "labels": torch.from_numpy(t[:, 1:].copy())})


def _max_diff(jtree, ttree) -> float:
    return max(float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))
               for a, (_, b) in zip(jax.tree.leaves(jtree), flatten(ttree)))


def test_configs_match_repro():
    for arch in ARCHS + ("qwen2_7b",):
        for reduced in (False, True):
            a, b = j_get_config(arch, reduced), get_config(arch, reduced)
            for f in dataclasses.fields(b):
                if f.name not in ("activation_dtype", "notes"):
                    assert getattr(a, f.name) == getattr(b, f.name), \
                        (arch, reduced, f.name)
            assert a.param_count() == b.param_count()


def test_schedules_match_repro():
    steps = list(range(0, 60, 3)) + [5, 29, 30, 31, 44, 45]
    pairs = [(j_sched.warmup_cosine(1e-3, 5, 50),
              schedules.warmup_cosine(1e-3, 5, 50)),
             (j_sched.warmup_cosine(2e-3, 0, 10, floor=0.0),
              schedules.warmup_cosine(2e-3, 0, 10, floor=0.0)),
             (j_sched.wsd(1e-3, 5, 30, 15), schedules.wsd(1e-3, 5, 30, 15)),
             (j_sched.constant(3e-4), schedules.constant(3e-4))]
    for jf, tf in pairs:
        for s in steps:
            a = float(jf(jnp.int32(s)))
            b = tf(torch.tensor(s, dtype=torch.int32))
            assert b.dtype == torch.float32
            assert float(b) == pytest.approx(a, rel=ULP_F32, abs=0)


def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": {"x": (7,), "y": (2, 3)}}

    def make(sc):
        return jax.tree.map(lambda s: (rng.normal(size=s) * sc).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    return make(1.0), [make(3.0) for _ in range(3)]


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_update_matches_repro(clip):
    params, grads = _opt_trees()
    sched = j_sched.warmup_cosine(1e-2, 1, 4)
    jc = j_adamw.AdamWConfig(lr=sched, grad_clip_norm=clip)
    tc = adamw.AdamWConfig(lr=schedules.warmup_cosine(1e-2, 1, 4),
                           grad_clip_norm=clip)
    pj = jax.tree.map(jnp.asarray, params)
    sj = j_adamw.init(pj)
    pt = from_jax(params, device="cpu")
    st = adamw.init(pt)
    for g in grads:
        pj, sj, mj = j_adamw.update(jc, jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st, mt = adamw.update(tc, from_jax(g, device="cpu"), st, pt)
        if clip:
            assert float(mt["grad_norm"]) == pytest.approx(
                float(mj["grad_norm"]), rel=1e-6)
            assert float(mt["grad_norm"]) > clip         # clipping is live
        assert float(mt["lr"]) == pytest.approx(float(mj["lr"]), rel=ULP_F32)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 3
    assert _max_diff(pj, pt) <= 1e-6
    assert _max_diff(sj["m"], st["m"]) <= 1e-6
    assert _max_diff(sj["v"], st["v"]) <= 1e-5


@pytest.mark.parametrize("smooth", [0.0, 0.05])
def test_linf_and_eq8_loss_match_repro(smooth):
    params, (g, eps, _) = _opt_trees(1)
    params["b"]["x"][3] = params["w"][2, 1] = 4.0        # a tie across leaves
    jp = jax.tree.map(jnp.asarray, params)
    je = jax.tree.map(jnp.asarray, eps)

    def j_total(p, e):
        return j_naf_loss.eq8_loss(jnp.float32(1.5), p, e, lambda1=0.3,
                                   lambda2=0.2, smooth=smooth)[0]
    a = float(j_total(jp, je))
    ga = jax.grad(j_total, argnums=(0, 1))(jp, je)
    tp = {k: v for k, v in from_jax(params, device="cpu").items()}
    te = from_jax(eps, device="cpu")
    for _, x in flatten(tp) + flatten(te):
        x.requires_grad_()
    total, reg = naf_loss.eq8_loss(torch.tensor(1.5), tp, te, lambda1=0.3,
                                   lambda2=0.2, smooth=smooth)
    assert total.item() == pytest.approx(a, rel=2 * ULP_F32)
    assert set(reg) == {"w_inf", "eps_inf"}
    total.backward()
    for jg, (_, x) in zip(jax.tree.leaves(ga), flatten(tp) + flatten(te)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-7)
    if not smooth:
        assert naf_loss.linf(tp).item() == float(j_naf_loss.linf(jp)) == 4.0


def test_make_batch_fn_matches_repro(capsys):
    cfg_j = j_synth.DataConfig(vocab_size=255, seq_len=32, global_batch=8)
    cfg_t = synthetic.DataConfig(vocab_size=255, seq_len=32, global_batch=8)
    jf = jax.jit(j_synth.make_batch_fn(cfg_j))
    tf = synthetic.make_batch_fn(cfg_t, device="cpu")
    ties = 0
    for step in (0, 1, 7, 100, 1000, 1029):
        a = {k: np.asarray(v) for k, v in jf(jnp.int32(step)).items()}
        b = {k: v.numpy() for k, v in tf(step).items()}
        assert b["tokens"].dtype == np.int32 and b["tokens"].shape == (8, 32)
        assert np.array_equal(a["tokens"][:, 0], b["tokens"][:, 0])
        assert np.array_equal(a["tokens"][:, 1:], b["labels"][:, :-1])
        for r in range(8):
            if not np.array_equal(a["labels"][r], b["labels"][r]):
                ties += 1               # a Gumbel near-tie: the row forks
    with capsys.disabled():
        print(f"\n[synthetic batches] rows forked at a Gumbel near-tie: "
              f"{ties} of 48")
    assert ties <= 1
    host = synthetic.host_batch(cfg_t, 7)
    assert np.array_equal(host["tokens"], tf(7)["tokens"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("on", [False, True], ids=["OFF", "ON"])
def test_train_forward_and_loss_match_repro(arch, on):
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    bj, bt = _batch(ct)
    lj, _ = jax.jit(lambda p, t: j_lm.forward(
        p, t, cj, mode="train", nldpe=JNLDPEConfig(enabled=on)))(
        pj, bj["tokens"])
    lt = lm.forward(pt, bt["tokens"], ct, mode="train",
                    nldpe=NLDPEConfig(enabled=on))
    assert lt.dtype == torch.float32 and lt.shape == (4, 16, ct.vocab_size)
    d = np.max(np.abs(np.asarray(lj) - lt.detach().numpy()), axis=-1)
    if on:
        assert np.mean(d > LOGIT_TOL) <= ON_FLIP_SHARE
        assert d.max() <= ON_LOGIT_TOL
    else:
        assert d.max() <= LOGIT_TOL
    a = float(j_lm.lm_loss(lj, bj["labels"]))
    b = float(lm.lm_loss(lt, bt["labels"]))
    assert b == pytest.approx(a, rel=1e-4 if on else LOSS_RTOL)
    assert float(lm.lm_loss(lt, bt["labels"], z_loss=0.0)) == pytest.approx(
        float(j_lm.lm_loss(lj, bj["labels"], z_loss=0.0)),
        rel=1e-4 if on else LOSS_RTOL)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma3_27b",
                                  "recurrentgemma_9b", "qwen3_moe_30b_a3b",
                                  "llama4_scout_17b_a16e", "rwkv6_3b"])
def test_scan_remat_recomputes_layers_with_equal_gradients(arch):
    """``cfg.scan_remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``): the same loss and gradients as without,
    bit for bit, for every block type (24 positions: past the reduced
    windows, so Gemma3's local layers run the band)."""
    _, ct = _cfgs(arch)
    _params(arch)
    _, bt = _batch(ct, s=16 if arch == "qwen2_5_3b" else 24)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(ct, scan_remat=remat)
        p = {k: v for k, v in from_jax(_PARAMS[arch], device="cpu").items()}
        leaves = [x.requires_grad_() for _, x in flatten(p)]
        loss = lm.lm_loss(lm.forward(p, bt["tokens"], cfg, mode="train"),
                          bt["labels"])
        out[remat] = (loss.item(),
                      torch.autograd.grad(loss, leaves))
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,naf", [("qwen2_5_3b", False),
                                      ("minicpm_2b", False),
                                      ("qwen2_5_3b", True)],
                         ids=["plain-qwen2_5_3b", "plain-minicpm_2b",
                              "naf-qwen2_5_3b"])
def test_train_step_matches_repro(arch, naf):
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    bj, bt = _batch(ct, seed=3)
    lr = 1e-3
    jstep = jax.jit(j_build(cj, j_adamw.AdamWConfig(lr=lr), naf=naf,
                            naf_lambda1=1e-2, naf_lambda2=1e-2))
    tstep = build_train_step(ct, adamw.AdamWConfig(lr=lr), naf=naf,
                             naf_lambda1=1e-2, naf_lambda2=1e-2)
    pj2, sj, mj = jstep(pj, j_adamw.init(pj), bj)
    st = adamw.init(pt)
    pt2, st2, mt = tstep(pt, st, bt)
    assert pt2 is pt and st2 is st                  # updated in place
    assert mt["loss"].item() == pytest.approx(float(mj["loss"]),
                                              rel=LOSS_RTOL)
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                   rel=1e-5)
    assert int(st["step"]) == int(sj["step"]) == 1
    assert _max_diff(sj["m"], st["m"]) <= M_TOL
    assert _max_diff(sj["v"], st["v"]) <= V_TOL
    assert _max_diff(pj2, pt) <= PARAM_TOL * lr
    # a second step through the same state (the NAF key folds in step 1)
    pj3, sj3, mj3 = jstep(pj2, sj, _batch(cj, seed=4)[0])
    pt3, st3, mt3 = tstep(pt, st, _batch(ct, seed=4)[1])
    assert mt3["loss"].item() == pytest.approx(float(mj3["loss"]),
                                               rel=1e-5)


def test_train_step_bf16_run_copy_and_timings():
    """At bf16 compute the forward runs on a bf16 copy of the masters
    (one cast, outside the layers); the masters stay float32 and the
    timed step reports its three phases."""
    _, ct = _cfgs("qwen2_5_3b")
    cfg = dataclasses.replace(ct, activation_dtype=torch.bfloat16)
    _, pt = _params("qwen2_5_3b")
    _, bt = _batch(ct)
    step = build_train_step(cfg, adamw.AdamWConfig(lr=1e-3), naf=True,
                            timed=True)
    pt, st, m = step(pt, adamw.init(pt), bt)
    assert all(x.dtype == torch.float32 for _, x in flatten(pt))
    assert np.isfinite(m["loss"].item())
    assert set(m["seconds"]) == {"noise", "fwd_bwd", "update"}


def test_cli_loss_falls_like_repro(capsys):
    """20 steps of the train CLI (reduced qwen2_7b, the defaults but the
    step count and a shorter sequence) fall like the reference CLI's: the
    port draws its own seeded weights, so the losses are compared by their
    fall, not step by step."""
    from repro.launch.train import run as j_run
    argv = ["--steps", "20", "--seq", "32"]
    ref = j_run(argv)
    mine = run(argv + ["--device", "cpu"])
    assert len(mine) == 20 and all(np.isfinite(mine))
    fall = lambda x: np.mean(x[:5]) - np.mean(x[-5:])
    assert fall(mine) > 0.1 and fall(ref) > 0.1
    assert fall(mine) == pytest.approx(fall(ref), rel=0.5)
    assert mine[0] == pytest.approx(ref[0], rel=0.02)   # both ~log(vocab)


def test_refusals(tmp_path):
    _, ct = _cfgs("qwen2_5_3b")
    with pytest.raises(NotImplementedError, match="FUSED"):
        build_train_step(ct, adamw.AdamWConfig(), nldpe=FUSED)
    # batch groups train (the refusal went with the mesh's training half)
    assert build_train_step(ct, adamw.AdamWConfig(),
                            batch_groups=2).specs is None
    with pytest.raises(NotImplementedError, match="FUSED"):
        lm.forward(_params("qwen2_5_3b")[1], torch.zeros((1, 4), dtype=
                   torch.int32), ct, mode="train", nldpe=FUSED)
    with pytest.raises(RuntimeError, match="injected failure at step 0"):
        run(["--ckpt-dir", str(tmp_path), "--fail-at-step", "0",
             "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run(["--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            synthetic.make_batch_fn(cfg=synthetic.DataConfig(8, 4, 2))


def test_from_jax_carries_optimizer_state_and_tables():
    pj = {"w": np.ones((2, 3), np.float64), "i": np.arange(4, dtype=np.int8)}
    st = j_adamw.init(jax.tree.map(jnp.asarray, pj))
    got = from_jax(jax.tree.map(np.asarray, st), device="cpu")
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()
    assert got["m"]["w"].dtype == torch.float32
    assert from_jax(pj, device="cpu")["i"].dtype == torch.int8
    jt = j_dt.build_table("silu")
    t = from_jax({"t": jt}, device="cpu")["t"]
    assert isinstance(t, dt.ACAMTable)
    assert np.array_equal(t.lo, jt.lo) and t.lo.dtype == np.float32
    assert t.out_spec.step == pytest.approx(jt.out_spec.step)
    assert t.rows_per_bit == jt.rows_per_bit
