"""The port's CNN substrate (``models/cnn.py``, ``data/images.py``, the
train and NAF steps of ``repro_torch.train_cnn_nldpe``) held against
``repro`` on the CPU: ``tests/test_cnn.py``'s reduced ``CFG`` with
``repro``'s own seeded weights (``convert.from_jax``), plus one full-width
``CNNConfig()`` forward.

Tolerances and their causes:

* ``_im2col`` and the labels: bitwise;
* the ``OFF`` conv: 2e-4, ``tests/test_cnn.py``'s own bound for two conv
  routes (f32 sums in another order; measured 4.8e-7 on the logits);
* the batch's images: ``IMAGE_TOL`` absolute against the jitted
  reference (XLA's ``sin``/``cos`` round apart from ``torch``'s, the
  normals within ``erf_inv``'s 4 ulps; measured 4.6e-6 on pixels up to
  2.8);
* ``ON`` logits: an input of an 8-bit ACAM ReLU that lands within an ulp
  of a threshold takes the other output code (one ACAM step, 8/255) when
  the conv before it sums in another order, and the flip spreads through
  the log-grid DMMul codes after it: logits within ``ON_LOGIT_TOL``
  (measured 4.8e-3 at full width against the jitted reference); the DMMul
  operands' codes are compared with the reference's and the flipped
  fraction reported;
* the crossbar noise: within ``NOISE_ULPS`` ulps of each leaf's w_max
  (tests/test_torch_naf.py);
* five train or NAF steps: the parameters within ``PARAM_TOL`` times the
  learning rate (Adam divides each gradient by its own magnitude;
  tests/test_torch_train.py), the losses within ``LOSS_RTOL``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.core import noise as j_noise
from repro.core.naf import inject_crossbar_noise as j_inject
from repro.data import images as j_images
from repro.models import cnn as j_cnn
from repro.nn.module import param_dtype
from repro.optim import adamw as j_adamw

from repro_torch import train_cnn_nldpe
from repro_torch.convert import from_jax
from repro_torch.core import engine, noise
from repro_torch.core.drift import flatten
from repro_torch.core.engine import OFF, ON
from repro_torch.core.logdomain import encode_live, log_quantize
from repro_torch.core.naf import inject_crossbar_noise, unflatten
from repro_torch.data import images
from repro_torch.launch import prng
from repro_torch.models import cnn
from repro_torch.optim import adamw

torch.set_num_threads(1)

CFG_KW = dict(stage_channels=(8, 16), blocks_per_stage=1, num_classes=4)
CFG, J_CFG = cnn.CNNConfig(**CFG_KW), j_cnn.CNNConfig(**CFG_KW)
DATA_KW = dict(num_classes=4, batch=16, noise=0.3)
IMAGE_TOL = 1e-5
OFF_TOL = 2e-4
ON_LOGIT_TOL = 1e-2
ON_FLIP_SHARE = 1e-2      # measured 3.5e-6 reduced, 2.4e-3 full width
NOISE_ULPS = 8
PARAM_TOL = 0.1
LOSS_RTOL = 1e-5
_CACHE = {}


def _params(cfg_kw=CFG_KW, key=0):
    """``repro``'s seeded init (jax leaves) and the port's float32 copy."""
    k = (tuple(sorted(cfg_kw.items())), key)
    if k not in _CACHE:
        with param_dtype(jnp.float32):
            _CACHE[k] = jax.jit(partial(j_cnn.init_params,
                                        cfg=j_cnn.CNNConfig(**cfg_kw)))(
                jax.random.key(key))
    pj = _CACHE[k]
    return pj, from_jax(jax.tree.map(np.asarray, pj), device="cpu")


def _images(shape, seed=1, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close_trees(a, b, atol):
    for (pa, x), (pb, y) in zip(flatten(a), flatten(b)):
        assert pa == pb
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   rtol=0, atol=atol, err_msg=str(pa))


@pytest.mark.parametrize("shape,k,stride", [
    ((2, 16, 16, 3), 3, 1), ((2, 16, 16, 3), 3, 2), ((2, 17, 13, 5), 3, 1),
    ((2, 17, 13, 5), 3, 2), ((1, 9, 7, 4), 1, 1), ((1, 9, 7, 4), 1, 2)])
def test_im2col_bitwise(shape, k, stride):
    """Patches in ``(dy, dx, c)`` order on XLA's SAME pads (asymmetric at
    stride 2), bit for bit ``repro``'s."""
    x = _images(shape, seed=0, scale=1.0)
    want = np.asarray(j_cnn._im2col(jnp.asarray(x), k, stride))
    got = cnn._im2col(torch.from_numpy(x), k, stride).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def test_same_pads_are_xla_s():
    assert cnn.same_pads(32, 3, 2) == (16, 0, 1)
    assert cnn.same_pads(32, 3, 1) == (32, 1, 1)
    assert cnn.same_pads(17, 3, 2) == (9, 1, 1)
    assert cnn.same_pads(16, 1, 2) == (8, 0, 0)


@pytest.mark.parametrize("shape,k", [((2, 16, 16, 3), 3), ((2, 17, 13, 5), 3),
                                     ((1, 9, 7, 4), 1)])
@pytest.mark.parametrize("stride", [1, 2])
def test_off_conv_matches_repro(shape, k, stride):
    """``conv_apply`` under ``OFF`` (conv2d on the explicit pad) against
    ``repro``'s ``lax.conv_general_dilated``, and the port's im2col matmul
    against its own conv (``tests/test_cnn.py``'s equivalence)."""
    with param_dtype(jnp.float32):
        pj = j_cnn.conv_init(jax.random.key(2), shape[-1], 8, k=k)
    pt = from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    x = _images(shape, seed=3, scale=1.0)
    want = np.asarray(j_cnn.conv_apply(pj, jnp.asarray(x), stride=stride))
    got = cnn.conv_apply(pt, torch.from_numpy(x), stride=stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=OFF_TOL, atol=OFF_TOL)
    cols = cnn._im2col(torch.from_numpy(x), k, stride)
    mat = (cols.reshape(-1, cols.shape[-1]) @ pt["w"].reshape(-1, 8)
           ).reshape(got.shape) + pt["b"]
    np.testing.assert_allclose(mat.numpy(), got.numpy(), rtol=OFF_TOL,
                               atol=OFF_TOL)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_forward_off_matches_repro(width):
    cfg_kw, b = (CFG_KW, 8) if width == "reduced" else ({}, 2)
    pj, pt = _params(cfg_kw)
    x = _images((b, 32, 32, 3))
    jcfg, tcfg = j_cnn.CNNConfig(**cfg_kw), cnn.CNNConfig(**cfg_kw)
    want = np.asarray(jax.jit(partial(j_cnn.forward, cfg=jcfg))(
        pj, jnp.asarray(x)))
    got = cnn.forward(pt, torch.from_numpy(x), tcfg)
    assert got.shape == (b, tcfg.num_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=OFF_TOL, atol=OFF_TOL)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_forward_on_matches_repro(width, monkeypatch, capsys):
    """``ON``: logits within ``ON_LOGIT_TOL`` of the jitted reference's;
    the log-grid codes of every DMMul operand (recorded at
    ``NLDPEConfig.dmmul``, the reference's through ``jax.debug.callback``
    inside its jitted forward) against the reference's: the flipped share
    at most ``ON_FLIP_SHARE``, and the first operand that differs differs
    by one ACAM output step (8/255 of the ReLU's range)."""
    cfg_kw, b = (CFG_KW, 8) if width == "reduced" else ({}, 2)
    pj, pt = _params(cfg_kw)
    x = _images((b, 32, 32, 3))
    jcfg, tcfg = j_cnn.CNNConfig(**cfg_kw), cnn.CNNConfig(**cfg_kw)
    seen = {"j": [], "t": []}
    j_dmmul, t_dmmul = j_engine.NLDPEConfig.dmmul, engine.NLDPEConfig.dmmul

    def rec_j(self, a, bm):
        jax.debug.callback(lambda v: seen["j"].append(np.array(v)), a,
                           ordered=True)
        return j_dmmul(self, a, bm)

    def rec_t(self, a, bm):
        seen["t"].append(a.clone())
        return t_dmmul(self, a, bm)

    monkeypatch.setattr(j_engine.NLDPEConfig, "dmmul", rec_j)
    monkeypatch.setattr(engine.NLDPEConfig, "dmmul", rec_t)
    jitted = np.asarray(jax.jit(partial(j_cnn.forward, cfg=jcfg,
                                        nldpe=j_engine.ON))(
        pj, jnp.asarray(x)))
    jax.effects_barrier()
    got = cnn.forward(pt, torch.from_numpy(x), tcfg, nldpe=ON)
    assert len(seen["t"]) == len(seen["j"]) == _conv_count(tcfg)
    flips = total = 0
    first = None
    for a, t in zip(seen["j"], seen["t"]):
        ca, sa = encode_live(torch.from_numpy(a))
        ct, st = encode_live(t)
        flip = (sa != st) | ((ca != ct) & (sa != 0))
        flips, total = flips + int(flip.sum()), total + flip.numel()
        if first is None and flip.any():
            first = np.abs(a - t.numpy()).max()
    share = flips / total
    err = np.abs(got.numpy() - jitted).max()
    with capsys.disabled():
        print(f"\n[cnn ON {width}] DMMul operand codes flipped: {flips} of "
              f"{total} ({share:.2e}); logits max |diff| vs jitted repro "
              f"{err:.2e}")
    assert share <= ON_FLIP_SHARE
    if first is not None:
        assert first == pytest.approx(8.0 / 255, rel=1e-3)
    assert torch.isfinite(got).all() and err <= ON_LOGIT_TOL


def _conv_count(cfg: cnn.CNNConfig) -> int:
    """Convolutions in one forward (stem, two a block, the projections)."""
    n, cin = 1, cfg.stem_channels
    for cout in cfg.stage_channels:
        n += 2 * cfg.blocks_per_stage + (cin != cout)
        cin = cout
    return n


def test_conv_count_of_the_full_width_cnn():
    """15 NL-DPE convolutions (kernel G launches on the card) in one
    ``CNNConfig()`` forward: stem, 12 in blocks, 2 projections."""
    assert _conv_count(cnn.CNNConfig()) == 15


def test_dmmul_on_cpu_is_the_plain_route():
    """``ON.dmmul`` on CPU tensors is ``matmul(log_quantize(a),
    log_quantize(b))`` bit for bit, at any rank, and launches nothing;
    ``OFF.dmmul`` is ``torch.matmul``."""
    from repro_torch.kernels.nldpe_qmatmul.ops import nldpe_qmatmul
    rng = np.random.default_rng(4)
    b = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
    before = nldpe_qmatmul.launches
    for shape in ((4, 9), (2, 3, 9)):
        a = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        want = torch.matmul(log_quantize(a), log_quantize(b))
        assert torch.equal(ON.dmmul(a, b), want)
        assert torch.equal(OFF.dmmul(a, b), torch.matmul(a, b))
    a3 = torch.from_numpy(rng.normal(size=(2, 4, 9)).astype(np.float32))
    b3 = torch.from_numpy(rng.normal(size=(2, 9, 5)).astype(np.float32))
    assert torch.equal(ON.dmmul(a3, b3), torch.matmul(log_quantize(a3),
                                                      log_quantize(b3)))
    a = torch.ones((3, 9), requires_grad=True)
    assert ON.dmmul(a, b).requires_grad      # the CPU route differentiates
    assert nldpe_qmatmul.launches == before


@pytest.mark.parametrize("kw", [DATA_KW, dict(num_classes=8, batch=24,
                                              noise=0.9),
                                dict(num_classes=10, img_size=17, channels=2,
                                     batch=5, seed=3)],
                         ids=["test", "example", "odd"])
def test_make_batch_fn_matches_repro(kw):
    jf = jax.jit(j_images.make_batch_fn(j_images.ImageDataConfig(**kw)))
    tf = images.make_batch_fn(images.ImageDataConfig(**kw), device="cpu")
    for step in (0, 7, 999):
        want, got = jf(jnp.int32(step)), tf(step)
        assert got["labels"].dtype == torch.int32
        assert got["images"].dtype == torch.float32
        assert np.array_equal(got["labels"].numpy(),
                              np.asarray(want["labels"]))
        np.testing.assert_allclose(got["images"].numpy(),
                                   np.asarray(want["images"]), rtol=0,
                                   atol=IMAGE_TOL)


def test_loss_and_accuracy_match_repro():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, 16).astype(np.int32)
    lj, lt = jnp.asarray(logits), torch.from_numpy(logits)
    yj, yt = jnp.asarray(labels), torch.from_numpy(labels)
    assert cnn.cnn_loss(lt, yt).item() == pytest.approx(
        float(j_cnn.cnn_loss(lj, yj)), rel=1e-6)
    assert cnn.accuracy(lt, yt).item() == float(j_cnn.accuracy(lj, yj))


def _j_steps(seen: list):
    """``repro``'s jitted train and NAF steps (tests/test_cnn.py); the NAF
    step hands its noisy weights to ``seen`` (``jax.debug.callback``)."""
    opt_cfg = j_adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    naf_cfg = j_adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
    model = j_noise.DEFAULT.rescale(3.0)

    @jax.jit
    def step(params, opt, batch):
        def loss_fn(p):
            return j_cnn.cnn_loss(j_cnn.forward(p, batch["images"], J_CFG),
                                  batch["labels"])
        loss, g = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = j_adamw.update(opt_cfg, g, opt, params)
        return params, opt, loss

    @jax.jit
    def naf_step(p, opt, batch, key):
        def loss_fn(p):
            pn = j_inject(key, p, model=model)
            jax.debug.callback(lambda t: seen.append(jax.tree.map(
                np.array, t)), pn, ordered=True)
            run = jax.tree.map(lambda a, b: a + jax.lax.stop_gradient(b - a),
                               p, pn)
            return j_cnn.cnn_loss(j_cnn.forward(run, batch["images"], J_CFG),
                                  batch["labels"])
        loss, g = jax.value_and_grad(loss_fn)(p)
        p, opt, _ = j_adamw.update(naf_cfg, g, opt, p)
        return p, opt, loss

    return step, naf_step


@pytest.mark.parametrize("kind", ["adamw", "naf"])
def test_five_steps_match_repro(kind):
    """Five AdamW steps under ``OFF`` (lr 3e-3) or five crossbar-NAF steps
    (3x noise, lr 1e-3) on the same batches, from ``repro``'s weights:
    the parameters within 0.1 x lr, the losses within ``LOSS_RTOL``.  The
    first NAF step's noisy weights (``inject_crossbar_noise`` on the CNN
    tree, one key per leaf in flatten order) within ``NOISE_ULPS`` ulps of
    each leaf's w_max of the reference's."""
    noisy = []
    j_step, j_naf = _j_steps(noisy)
    pj, pt = _params()
    if kind == "naf":
        model = noise.DEFAULT.rescale(3.0)
        mine = inject_crossbar_noise(prng.prng_key(0), pt, model=model)
    oj, ot = j_adamw.init(pj), adamw.init(pt)
    jf = jax.jit(j_images.make_batch_fn(j_images.ImageDataConfig(**DATA_KW)))
    lr = 3e-3 if kind == "adamw" else 1e-3
    for i in range(5):
        bj = jf(jnp.int32(i))
        bt = {k: torch.from_numpy(np.array(v)) for k, v in bj.items()}
        if kind == "adamw":
            pj, oj, lj = j_step(pj, oj, bj)
            pt, ot, lt = train_cnn_nldpe.train_step(
                pt, ot, bt, CFG, adamw.AdamWConfig(lr=lr, weight_decay=0.0))
        else:
            pj, oj, lj = j_naf(pj, oj, bj, jax.random.key(i))
            pt, ot, lt = train_cnn_nldpe.naf_step(
                pt, ot, bt, prng.prng_key(i), CFG,
                adamw.AdamWConfig(lr=lr, weight_decay=0.0),
                model)
        assert lt.item() == pytest.approx(float(lj), rel=LOSS_RTOL)
    assert int(ot["step"]) == int(oj["step"]) == 5
    if kind == "naf":
        jax.effects_barrier()
        assert len(noisy) == 5
        for (path, x), (_, w), (_, y) in zip(flatten(mine), flatten(
                from_jax(jax.tree.map(np.asarray, _params()[0]),
                         device="cpu")), flatten(noisy[0])):
            wmax = max(np.float32(w.abs().max().item()), np.float32(1e-6))
            assert np.abs(x.numpy() - y).max() \
                <= NOISE_ULPS * np.spacing(wmax), path
    _close_trees(pt, pj, PARAM_TOL * lr)


@pytest.fixture(scope="module")
def trained():
    """``tests/test_cnn.py``'s ``_train_small_cnn`` on the port: 60 AdamW
    steps from the port's seeded weights; (params, batch_fn, losses,
    accuracy)."""
    params = cnn.init_params(CFG, device="cpu")
    opt = adamw.init(params)
    batch_fn = images.make_batch_fn(images.ImageDataConfig(**DATA_KW),
                                    device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    losses = []
    for i in range(60):
        params, opt, loss = train_cnn_nldpe.train_step(
            params, opt, batch_fn(i), CFG, opt_cfg)
        losses.append(loss.item())
    b = batch_fn(999)
    with torch.no_grad():
        acc = cnn.accuracy(cnn.forward(params, b["images"], CFG),
                           b["labels"]).item()
    return params, batch_fn, losses, acc


def test_cnn_learns_synthetic_task(trained):
    _, _, losses, acc = trained
    assert losses[-1] < losses[0] * 0.8
    assert acc > 1.5 / CFG.num_classes      # clearly above chance


def test_nldpe_mode_tracks_fp32():
    """``repro``'s bound: the ``ON`` logits' mean squared error under 0.3
    of the float logits' variance (``repro``'s seed-3 weights)."""
    _, pt = _params(key=3)
    x = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.key(4), (2, 32, 32, 3))) * 0.5)
    ref = cnn.forward(pt, x, CFG)
    analog = cnn.forward(pt, x, CFG, nldpe=ON)
    assert torch.isfinite(analog).all()
    rel = torch.mean((analog - ref) ** 2) / torch.clamp(torch.var(
        ref, unbiased=False), min=1e-9)
    assert rel.item() < 0.3


def test_crossbar_noise_then_naf_recovers_cnn(trained):
    """Weight noise degrades accuracy; 40 crossbar-NAF steps never hurt
    (``recovered >= degraded - 0.02``) and recover a fraction where the
    noise bit (``repro``'s bounds)."""
    params, batch_fn, _, _ = trained
    params = unflatten(params, [w.clone() for _, w in flatten(params)])
    model = noise.DEFAULT.rescale(3.0)

    def noisy_acc(p, draws=4):
        accs = []
        with torch.no_grad():
            for i in range(draws):
                pn = inject_crossbar_noise(prng.prng_key(50 + i), p,
                                           model=model)
                b = batch_fn(500 + i)
                accs.append(cnn.accuracy(cnn.forward(pn, b["images"], CFG),
                                         b["labels"]).item())
        return float(np.mean(accs))

    b = batch_fn(999)
    with torch.no_grad():
        clean = cnn.accuracy(cnn.forward(params, b["images"], CFG),
                             b["labels"]).item()
    degraded = noisy_acc(params)
    opt = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
    for i in range(40):
        params, opt, _ = train_cnn_nldpe.naf_step(
            params, opt, batch_fn(1000 + i), prng.prng_key(i), CFG, opt_cfg,
            model)
    recovered = noisy_acc(params)
    assert recovered >= degraded - 0.02
    if clean - degraded > 0.05:
        assert recovered > degraded + 0.3 * (clean - degraded)


def test_init_params_tree_and_distributions():
    """``repro``'s tree, shapes and dtypes; conv weights ~ N(0, 1/(k*k*cin))
    and the head ~ N(0, 1/cin); seeded CPU draws, equal on every call."""
    pj, _ = _params({})
    mine = cnn.init_params(cnn.CNNConfig(), device="cpu")
    again = cnn.init_params(cnn.CNNConfig(), device="cpu")
    ref = dict(flatten(jax.tree.map(np.asarray, pj)))
    assert [p for p, _ in flatten(mine)] == list(ref)
    for path, w in flatten(mine):
        assert tuple(w.shape) == ref[path].shape and w.dtype == torch.float32
        assert torch.equal(w, dict(flatten(again))[path])
        if path[-1] == "w" and w.dim() == 4:
            k, _, cin, _ = w.shape
            assert w.std().item() == pytest.approx((k * k * cin) ** -0.5,
                                                   rel=0.2)
        if path[-1] in ("b",):
            assert not w.any()
        if path[-1] == "scale":
            assert torch.equal(w, torch.ones_like(w))


def test_train_cnn_cli_end_to_end(monkeypatch, capsys):
    """``python -m repro_torch.train_cnn_nldpe --device cpu``: every stage
    runs and prints (the step counts cut to 12 and 4 here; the learning
    and NAF bounds are the tests above), and ``main`` returns finite
    numbers; without a GPU the default device raises."""
    monkeypatch.setattr(train_cnn_nldpe, "TRAIN_STEPS", 12)
    monkeypatch.setattr(train_cnn_nldpe, "NAF_STEPS", 4)
    res = train_cnn_nldpe.cli(["--device", "cpu"])
    out = capsys.readouterr().out
    for needle in ("[cnn] step   0", "accuracy fp32=", "NL-DPE numerics=",
                   "after crossbar NAF", "cnn example OK"):
        assert needle in out
    assert len(res["losses"]) == 12
    assert all(np.isfinite(v) for k, v in res.items() if k != "losses")
    assert 0.0 <= res["nldpe_acc"] <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cnn_nldpe.main()
