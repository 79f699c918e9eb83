"""The port's Noise-Aware Fine-tuning (``core/noise.noisy_thresholds``,
``core/differentiable.py``, ``core/naf.py``, D-SL slicing and
``quantization.fake_quant_ste``) held against ``repro`` on the CPU.

What is bitwise and what is not, and why:

* Keys, uniforms and integer logic (the ACAM interval match, D-SL digits)
  are bitwise.  Threefry normals are within 4 ulps (XLA's ``erf_inv``
  polynomial, ROADMAP C), and Eq 7's ``exp``/``log`` round an ulp
  apart between the frameworks, so a threshold through the cells lands
  within ``TH_TOL`` of the reference's (a few ulps of the [-8, 8] span).
* The hard (exact-comparison) forward is then bitwise wherever no noisy
  threshold lies within ``TH_TOL`` of the input; the soft forwards are
  within the slope times ``TH_TOL`` (``SOFT_TOL``, ``ALG1_TOL``).
* Gradients of both NAF losses: within ``GRAD_RTOL`` of ``jax.grad``'s
  largest element (f32 sums in another order, ``sigmoid``/``exp`` ulps).
* ``finetune_table`` end to end: ``mse_before`` and ``mse_clean`` are
  eager hard evaluations, held within ``MSE_RTOL``; ``mse_after`` and the
  history pass through training steps that compound the ulps above, held
  within ``TRAIN_RTOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import differentiable as j_diff
from repro.core.acam import eval_table_np
from repro.core import dt as j_dt
from repro.core import naf as j_naf
from repro.core import noise as j_noise
from repro.core import quantization as j_quant
from repro.core import slicing as j_slicing
from repro.core.functions import FUNCTIONS as J_FUNCTIONS

from repro_torch.core import differentiable, dt, naf, noise, quantization
from repro_torch.core import drift, slicing
from repro_torch.launch import prng

torch.set_num_threads(1)

TH_TOL = 16.0 * 2 ** -21     # thresholds through the cells (span 16)
SOFT_TOL = 20 * 0.25 * TH_TOL * 2   # soft_gray_bits: beta * sigmoid' * 2 sides
ALG1_TOL = 1e-4             # diff_acam_forward values (relu window, f32)
GRAD_RTOL = 1e-3            # NAF-loss gradients, of the largest element
MSE_RTOL = 1e-5             # mse_before, mse_clean
TRAIN_RTOL = 2e-2           # mse_after, history (compounded over steps)
NOISE_ULPS = 8              # inject_crossbar_noise: normals' 4 ulps, x2 cells

MODELS = {"ideal": (j_noise.IDEAL, noise.IDEAL),
          "noisy": (j_noise.DEFAULT.rescale(2.0), noise.DEFAULT.rescale(2.0))}


def _key(seed: int):
    return jax.random.key(seed), prng.prng_key(seed)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _n(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tables(name="gelu"):
    jt, tt = j_dt.build_table(name), dt.build_table(name)
    assert np.array_equal(jt.lo, tt.lo) and np.array_equal(jt.hi, tt.hi)
    return jt, tt


def _close_thresholds(a, b):
    a, b = _n(a), _n(b)
    pad = np.abs(a) >= 1e29
    assert np.array_equal(a[pad], b[pad])           # padding passes through
    assert np.max(np.abs(a - b)[~pad], initial=0.0) <= TH_TOL


@pytest.mark.parametrize("which", ["ideal", "noisy"])
def test_noisy_thresholds_matches_repro(which):
    jm, tm = MODELS[which]
    jt, _ = _tables()
    jk, tk = _key(3)
    jl, jh = j_noise.noisy_thresholds(jk, jnp.asarray(jt.lo),
                                      jnp.asarray(jt.hi), (-8.0, 8.0), jm)
    tl, th = noise.noisy_thresholds(tk, _t(jt.lo), _t(jt.hi), (-8.0, 8.0),
                                    tm)
    _close_thresholds(jl, tl)
    _close_thresholds(jh, th)
    if which == "ideal":                     # the reference's identity test
        lo = torch.tensor([[-1.0, 0.5]])
        hi = torch.tensor([[0.0, 2.0]])
        l2, h2 = noise.noisy_thresholds(tk, lo, hi, (-4, 4), noise.IDEAL)
        np.testing.assert_allclose(_n(l2), _n(lo), atol=1e-3)
        np.testing.assert_allclose(_n(h2), _n(hi), atol=1e-3)


@pytest.mark.parametrize("which", ["ideal", "noisy"])
def test_thresholds_through_cells_match_repro(which):
    jm, tm = MODELS[which]
    jt, _ = _tables("silu")
    jk, tk = _key(4)
    for arr in (jt.lo, jt.hi):
        a = j_diff._thresholds_through_cells(
            jk, jnp.asarray(arr), j_diff.DiffACAMConfig(), jm)
        b = differentiable._thresholds_through_cells(
            tk, _t(arr), differentiable.DiffACAMConfig(), tm)
        _close_thresholds(a, b)


def _forward_inputs(n=400, seed=0):
    return np.random.default_rng(seed).uniform(-8, 8, n).astype(np.float32)


@pytest.mark.parametrize("which", ["ideal", "noisy"])
def test_diff_and_soft_forwards_match_repro(which):
    jm, tm = MODELS[which]
    jt, _ = _tables()
    xs = _forward_inputs()
    jk, tk = _key(5)
    kw_j = dict(rng=jk, cfg=j_diff.DiffACAMConfig(), model=jm)
    kw_t = dict(rng=tk, cfg=differentiable.DiffACAMConfig(), model=tm)
    grid = dict(out_lo=jt.out_spec.lo, out_step=jt.out_spec.step)
    a = j_diff.diff_acam_forward(jnp.asarray(xs), jnp.asarray(jt.lo),
                                 jnp.asarray(jt.hi), **kw_j, **grid)
    b = differentiable.diff_acam_forward(_t(xs), _t(jt.lo), _t(jt.hi),
                                         **kw_t, **grid)
    assert np.max(np.abs(_n(a) - _n(b))) <= ALG1_TOL
    a = j_diff.soft_gray_bits(jnp.asarray(xs), jnp.asarray(jt.lo),
                              jnp.asarray(jt.hi), **kw_j)
    b = differentiable.soft_gray_bits(_t(xs), _t(jt.lo), _t(jt.hi), **kw_t)
    assert _n(b).shape == (len(xs), 8)
    assert np.max(np.abs(_n(a) - _n(b))) <= SOFT_TOL


@pytest.mark.parametrize("which", ["ideal", "noisy"])
def test_hard_forward_matches_repro(which):
    """Bitwise wherever no noisy threshold is within TH_TOL of x; the
    reference's own ideal check (soft within half a step of the hard)."""
    jm, tm = MODELS[which]
    jt, _ = _tables("sigmoid")
    xs = _forward_inputs(512)
    jk, tk = _key(6)
    grid = dict(out_lo=jt.out_spec.lo, out_step=jt.out_spec.step)
    a = _n(j_diff.hard_acam_forward(jnp.asarray(xs), jnp.asarray(jt.lo),
                                    jnp.asarray(jt.hi), rng=jk, model=jm,
                                    **grid))
    b = _n(differentiable.hard_acam_forward(_t(xs), _t(jt.lo), _t(jt.hi),
                                            rng=tk, model=tm, **grid))
    k1, k2 = prng.split(tk)
    cfg = differentiable.DiffACAMConfig()
    wl = _n(differentiable._thresholds_through_cells(k1, _t(jt.lo), cfg, tm))
    wh = _n(differentiable._thresholds_through_cells(k2, _t(jt.hi), cfg, tm))
    near = (np.abs(xs[:, None, None] - wl[None]) <= TH_TOL).any((1, 2)) \
        | (np.abs(xs[:, None, None] - wh[None]) <= TH_TOL).any((1, 2))
    assert np.array_equal(a[~near], b[~near])
    assert near.mean() < 0.01
    if which == "ideal":
        soft = differentiable.diff_acam_forward(_t(xs), _t(jt.lo),
                                                _t(jt.hi), **grid)
        np.testing.assert_allclose(_n(soft), eval_table_np(jt, xs),
                                   atol=jt.out_spec.step * 0.5)


def _loss_pair(objective, jt, xs, noise_draws=2, beta=20.0):
    """``finetune_table``'s loss in both packages: the reference's closure
    rebuilt from its public pieces, and the port's ``naf_loss``."""
    spec = jt.out_spec
    levels = naf._quantized_target(J_FUNCTIONS[jt.name].fn, xs, spec)
    y = (levels * spec.step + spec.lo).astype(np.float32)
    gray = levels ^ (levels >> 1)
    gb = ((gray[:, None] >> np.arange(jt.bits)) & 1).astype(np.float32)
    jcfg = j_diff.DiffACAMConfig(bits=jt.bits, th_lo=-8.0, th_hi=8.0)
    model_j, model_t = MODELS["noisy"]
    bit_w = jnp.asarray([4.0 ** i for i in range(jt.bits)])
    bit_w = bit_w / jnp.sum(bit_w)

    def j_loss(p, key):
        def one(k):
            if objective == "per_bit":
                sb = j_diff.soft_gray_bits(jnp.asarray(xs), p["lo"], p["hi"],
                                           rng=k, cfg=jcfg, model=model_j,
                                           beta=beta)
                return jnp.mean(jnp.sum(bit_w * (sb - gb) ** 2, axis=-1))
            yy = j_diff.diff_acam_forward(jnp.asarray(xs), p["lo"], p["hi"],
                                          rng=k, cfg=jcfg, model=model_j,
                                          out_lo=spec.lo,
                                          out_step=spec.step)
            return jnp.mean((yy - y) ** 2)
        return jnp.mean(jax.vmap(one)(jax.random.split(key, noise_draws)))

    t_bit_w = torch.tensor([4.0 ** i for i in range(jt.bits)])
    t_bit_w = t_bit_w / t_bit_w.sum()

    def t_loss(p, key):
        return naf.naf_loss(
            p, key, _t(xs), _t(y), _t(gb),
            cfg=differentiable.DiffACAMConfig(bits=jt.bits), model=model_t,
            noise_draws=noise_draws, objective=objective, beta=beta,
            bit_w=t_bit_w, out_lo=float(spec.lo), out_step=float(spec.step))
    return j_loss, t_loss


@pytest.mark.parametrize("objective", ["per_bit", "alg1"])
def test_naf_loss_gradients_match_jax_grad(objective):
    jt, _ = _tables("tanh")
    xs = np.linspace(-7, 7, 128).astype(np.float32)
    j_loss, t_loss = _loss_pair(objective, jt, xs)
    jk, tk = _key(7)
    pj = {"lo": jnp.asarray(jt.lo), "hi": jnp.asarray(jt.hi)}
    # per_bit as finetune_table runs it (jitted); alg1 eagerly: under jit
    # XLA's division rewrites move the gradients of its least-significant
    # rows by up to 2.5e-3 of the largest, past GRAD_RTOL
    grad = jax.value_and_grad(j_loss)
    lj, gj = (jax.jit(grad) if objective == "per_bit" else grad)(pj, jk)
    pt = {k: _t(v).requires_grad_() for k, v in (("lo", jt.lo),
                                                  ("hi", jt.hi))}
    lt = t_loss(pt, tk)
    gt = torch.autograd.grad(lt, [pt["lo"], pt["hi"]])
    assert lt.item() == pytest.approx(float(lj), rel=1e-5)
    for name, g in zip(("lo", "hi"), gt):
        ref = np.asarray(gj[name])
        assert np.all(np.isfinite(_n(g)))
        scale = np.max(np.abs(ref))
        assert scale > 0
        assert np.max(np.abs(ref - _n(g))) <= GRAD_RTOL * scale


def test_corrupt_table_matches_repro():
    jt, tt = _tables()
    jk, tk = _key(42)
    a = j_naf.corrupt_table(jt, jk, j_noise.DEFAULT.rescale(6.0))
    b = naf.corrupt_table(tt, tk, noise.DEFAULT.rescale(6.0), device="cpu")
    assert isinstance(b, dt.ACAMTable)
    _close_thresholds(a.lo, b.lo)
    _close_thresholds(a.hi, b.hi)
    assert not np.array_equal(b.lo, jt.lo)          # the pass moved them


def test_fake_quant_ste_forward_and_identity_gradient():
    jspec = j_quant.QuantSpec(-1.0, 1.0, 4)
    tspec = quantization.QuantSpec(-1.0, 1.0, 4)
    x = np.linspace(-1.2, 1.2, 37).astype(np.float32)
    xt = _t(x).requires_grad_()
    y = quantization.fake_quant_ste(xt, tspec)
    assert np.array_equal(_n(y), np.asarray(j_quant.fake_quant_ste(
        jnp.asarray(x), jspec)))
    g, = torch.autograd.grad(torch.sum(y * 3.0), xt)
    gj = jax.grad(lambda v: jnp.sum(j_quant.fake_quant_ste(v, jspec) * 3.0))(
        jnp.asarray(x))
    assert np.array_equal(_n(g), np.asarray(gj))
    assert np.all(_n(g) == 3.0)


@pytest.mark.parametrize("noisy", [False, True])
def test_dsl_plan_and_effective_weight_match_repro(noisy):
    rng = np.random.default_rng(3)
    w = np.clip(rng.normal(size=(8, 8)), -2.0, 2.0).astype(np.float32)
    jplans = j_slicing.plan_dsl(jnp.asarray(w), 2.0, bits=8, cell_bits=2)
    tplans = slicing.plan_dsl(_t(w), 2.0, bits=8, cell_bits=2)
    assert len(jplans) == len(tplans) == 4
    for a, b in zip(jplans, tplans):
        for f in ("g_pos_main", "g_neg_main", "g_pos_res", "g_neg_res"):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  _n(getattr(b, f)))
    jk, tk = _key(8) if noisy else (None, None)
    a = np.asarray(j_slicing.effective_weight_dsl(jplans, 2, 8, rng=jk))
    b = _n(slicing.effective_weight_dsl(tplans, 2, 8, rng=tk))
    if noisy:        # read normals within 4 ulps, scaled by the recombination
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    else:
        assert np.array_equal(a, b)
        assert np.max(np.abs(b - w)) < 2.0 / 255 + 1e-3


def _small_tree():
    rng = np.random.default_rng(9)
    return {"b": rng.normal(size=(3,)).astype(np.float32) * 0.5,
            "a": {"w": rng.normal(size=(8, 4)).astype(np.float32),
                  "u": rng.normal(size=(5, 7)).astype(np.float32) * 0.1}}


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ai = a.astype(np.float32).view(np.int32).astype(np.int64)
    bi = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def test_inject_crossbar_noise_matches_repro(monkeypatch):
    """Keys per leaf in flatten order, w_max over each leaf: noisy weights
    within NOISE_ULPS of the leaf's w_max of the reference's; the chunked
    draw (CHUNK forced to 7 elements) equals the whole-leaf draw bit for
    bit; IDEAL passes through, and the default model perturbs but stays
    near (the reference's own structure test)."""
    tree = _small_tree()
    jk, tk = _key(0)
    a = j_naf.inject_crossbar_noise(jk, jax.tree.map(jnp.asarray, tree))
    tt = {"b": _t(tree["b"]), "a": {k: _t(v) for k, v in tree["a"].items()}}
    b = naf.inject_crossbar_noise(tk, tt)
    assert list(b) == list(tt) and list(b["a"]) == list(tt["a"])
    for (path, x), y in zip(drift.flatten(b), jax.tree.leaves(a)):
        w = drift.flatten(tt)[[p for p, _ in drift.flatten(tt)].index(path)][1]
        wmax = float(np.max(np.abs(_n(w))))
        assert np.max(np.abs(_n(x) - np.asarray(y))) \
            <= NOISE_ULPS * np.spacing(np.float32(wmax))
    monkeypatch.setattr(drift, "CHUNK", 7)
    c = naf.inject_crossbar_noise(tk, tt)
    for (_, x), (_, y) in zip(drift.flatten(b), drift.flatten(c)):
        assert torch.equal(x, y)
    clean = naf.inject_crossbar_noise(tk, tt, model=noise.IDEAL)
    np.testing.assert_allclose(_n(clean["a"]["w"]), tree["a"]["w"],
                               atol=1e-4)
    ones = naf.inject_crossbar_noise(tk, {"w": torch.ones((8, 4))})
    d = float(torch.max(torch.abs(ones["w"] - 1.0)))
    assert 0 < d < 0.5
    w_inf, e_inf = naf.eq8_regularizers(tt, {"x": b["b"] - tt["b"]})
    jw, je = j_naf.eq8_regularizers(jax.tree.map(jnp.asarray, tree),
                                    {"x": a["b"] - jnp.asarray(tree["b"])})
    assert float(w_inf) == float(jw)
    assert float(e_inf) == pytest.approx(float(je), abs=1e-6)


def _finetune_pair(table, key, model_name, **kw):
    jm, tm = MODELS[model_name]
    jk, tk = _key(key)
    return (j_naf.finetune_table(table, rng=jk, model=jm, **kw),
            naf.finetune_table(table, rng=tk, model=tm, device="cpu", **kw))


@pytest.mark.parametrize("objective", ["per_bit", "alg1"])
def test_finetune_table_matches_repro(objective):
    jt, _ = _tables()
    bad = j_naf.corrupt_table(jt, jax.random.key(42),
                              j_noise.DEFAULT.rescale(6.0))
    a, b = _finetune_pair(bad, 0, "noisy", epochs=2, samples=600, batch=200,
                          objective=objective)
    assert b.mse_before == pytest.approx(a.mse_before, rel=MSE_RTOL)
    assert b.mse_clean == pytest.approx(a.mse_clean, rel=MSE_RTOL)
    assert b.mse_after == pytest.approx(a.mse_after, rel=TRAIN_RTOL)
    assert b.epochs == a.epochs and len(b.history) == len(a.history)
    for x, y in zip(a.history, b.history):
        assert x["epoch"] == y["epoch"]
        assert y["train_loss"] == pytest.approx(x["train_loss"],
                                                rel=TRAIN_RTOL)
        assert y["hard_mse"] == pytest.approx(x["hard_mse"], rel=TRAIN_RTOL)
    assert b.table.lo.dtype == np.float32 and b.table.lo.shape == jt.lo.shape


def test_acam_noise_degrades_then_naf_recovers():
    """``tests/test_naf.py``'s Table III pattern on the port: a persistent
    programming realization degrades the DT badly; per-DT NAF repairs it
    toward the noise floor."""
    _, t = _tables()
    model = noise.DEFAULT.rescale(2.0)
    t_bad = naf.corrupt_table(t, prng.prng_key(42), model.rescale(6.0),
                              device="cpu")
    res = naf.finetune_table(t_bad, rng=prng.prng_key(0), model=model,
                             epochs=6, samples=2500, batch=256,
                             noise_draws=4, device="cpu")
    floor = naf.finetune_table(t, rng=prng.prng_key(0), model=model,
                               epochs=0, samples=64, device="cpu").mse_before
    assert res.mse_before > 3 * floor
    assert res.mse_after < 0.5 * res.mse_before
    assert res.mse_after < 3 * floor


def test_naf_nominal_table_holds_ground():
    _, t = _tables("silu")
    res = naf.finetune_table(t, rng=prng.prng_key(1),
                             model=noise.DEFAULT.rescale(2.0), epochs=3,
                             samples=1500, batch=256, noise_draws=4,
                             device="cpu")
    assert res.mse_after < 1.3 * res.mse_before


def test_alg1_objective_available():
    _, t = _tables("tanh")
    res = naf.finetune_table(t, rng=prng.prng_key(2), model=noise.DEFAULT,
                             epochs=1, samples=500, batch=250,
                             objective="alg1", device="cpu")
    assert res.epochs == 1 and len(res.history) == 1
    with pytest.raises(ValueError, match="objective"):
        naf.finetune_table(t, objective="nope", device="cpu")


def test_quickstart_section3_matches_repro():
    """Section 3 of the quickstart (corrupt the GELU table, repair it) on
    the CPU, against what ``examples/quickstart.py`` prints for the same
    calls (1.05e-02 clean, 1.17e-02 corrupted, 4.64e-03 after NAF)."""
    from repro_torch import quickstart
    out = quickstart.naf_section(dt.build_table("gelu"), "cpu")
    assert out["naf_mse_clean"] == pytest.approx(1.05e-2, rel=5e-3)
    assert out["naf_mse_before"] == pytest.approx(1.17e-2, rel=5e-3)
    assert out["naf_mse_after"] == pytest.approx(4.64e-3, rel=5e-3)
    assert out["naf_mse_after"] < 0.5 * out["naf_mse_before"]
