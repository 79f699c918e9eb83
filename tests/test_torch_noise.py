"""The port's device model held against ``repro`` on the CPU: threefry
``split``/``uniform``/``normal``/``bernoulli`` (``launch/prng.py``) against
``jax.random``, the Eq 5-7 noise model and stuck-at faults
(``core/noise.py``), A-SL programming with noise (``core/slicing.py``)
and the noisy crossbar VMM (``core/crossbar.py``).

Tolerances, each stated at its assertion:

* bitwise — keys, bits, uniforms, Bernoulli and fault masks (integer and
  compare logic on the same threefry words), ideal programming;
* normals — within ``NORMAL_ULPS`` ulps: the port evaluates XLA's
  float32 ``erf_inv`` polynomial with its FMA roundings, but its
  ``log1p`` and ``sqrt`` round apart from XLA's now and then (measured:
  at most 3 ulps, on about 1% of 2M draws; ``torch.erfinv`` itself is up
  to 91 ulps from XLA's polynomial in the tails);
* float32 values that pass through ``exp``/``log`` (sigmas, noisy cells,
  thresholds): a few ulps relative, as stated;
* matmul outputs — float32 sum order, relative to sum |x||w|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as j_crossbar
from repro.core import noise as j_noise
from repro.core import slicing as j_slicing
from repro.core.quantization import QuantSpec as JQuantSpec

from repro_torch.core import crossbar, noise, slicing
from repro_torch.core.quantization import QuantSpec
from repro_torch.launch import prng

torch.set_num_threads(1)

NORMAL_ULPS = 4
SEEDS = [0, 7, 2**31 + 5]
U32 = 2.0 ** -24


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(k):
    return np.asarray(k).astype(np.int64)


def _ulps(a, b):
    """ulp distance of two float32 arrays of one sign convention."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.int32),
                                  np.asarray(b, np.float32).view(np.int32))


# -- threefry draws -------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_match_jax_bitwise(seed):
    jk, tk = _jkey(seed), prng.prng_key(seed)
    for num in (2, 4, 7):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _words(jax.random.split(jk, num)))
    np.testing.assert_array_equal(prng.fold_in(tk, 7).numpy(),
                                  _words(jax.random.fold_in(jk, 7)))
    # split of a split key, as plan_asl -> program -> readout nests them
    sub = prng.split(prng.split(tk, 4)[2])
    np.testing.assert_array_equal(
        sub.numpy(), _words(jax.random.split(jax.random.split(jk, 4)[2])))


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 5), (64, 48)])
@pytest.mark.parametrize("seed", SEEDS)
def test_shaped_bits_uniform_bernoulli_match_jax_bitwise(seed, shape):
    """Any shape takes jax's row-major counter layout; uniforms with a
    ``maxval`` round the scale-and-shift once, as XLA's FMA does."""
    jk, tk = _jkey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (-3.3, 7.1), (0.25, 0.5), (-1e-3, 2e5)):
        _bits_equal(prng.uniform(tk, shape, lo, hi).numpy(),
                    jax.random.uniform(jk, shape, jnp.float32, lo, hi))
    for p in (0.01, 0.3, 0.5):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normals_within_ulps_of_jax(seed):
    """2^20 draws and a 2-D shape: within ``NORMAL_ULPS`` (module
    docstring); most draws are bitwise."""
    jk, tk = _jkey(seed), prng.prng_key(seed)
    for shape in ((1 << 20,), (300, 77)):
        mine = prng.normal(tk, shape).numpy()
        ref = np.asarray(jax.random.normal(jk, shape, jnp.float32))
        d = _ulps(mine, ref)
        assert d.max() <= NORMAL_ULPS
        assert (d == 0).mean() > 0.95


def test_erf_inv_is_xla_polynomial_not_erfinv():
    """The tails: XLA's polynomial, not the correctly rounded inverse."""
    u = torch.tensor([-0.999829, 0.9999, -0.5, 0.0, 0.3], dtype=torch.float32)
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    assert _ulps(prng.erf_inv(u).numpy(), ref).max() <= NORMAL_ULPS
    assert _ulps(torch.erfinv(u).numpy(), ref).max() > 10


# -- the noise model ------------------------------------------------------

BAD_MODELS = [dict(scale=float("nan")), dict(scale=float("inf")),
              dict(scale=-0.5), dict(scale=np.float32(1.0)),
              dict(scale="1"), dict(g_min=150.0, g_max=150.0),
              dict(g_min=0.0), dict(g_min=200.0)]


@pytest.mark.parametrize("kw", BAD_MODELS)
def test_noise_model_validation_matches_repro(kw):
    """The same arguments raise the same ``ValueError`` in both."""
    with pytest.raises(ValueError) as j_err:
        j_noise.NoiseModel(**kw)
    with pytest.raises(ValueError) as t_err:
        noise.NoiseModel(**kw)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("kw", [dict(scale=0), dict(scale=2.5),
                                dict(scale=True), dict(g_min=1e-3)])
def test_noise_model_accepts_what_repro_accepts(kw):
    j_noise.NoiseModel(**kw)
    noise.NoiseModel(**kw)


@pytest.mark.parametrize("rate", [-0.1, 1.5, float("nan")])
def test_stuck_at_rate_check_matches_repro(rate):
    g = np.full((8,), 50.0, np.float32)
    with pytest.raises(ValueError) as j_err:
        j_noise.stuck_at_faults(_jkey(0), jnp.asarray(g), rate)
    with pytest.raises(ValueError) as t_err:
        noise.stuck_at_faults(prng.prng_key(0), torch.from_numpy(g), rate)
    assert str(t_err.value) == str(j_err.value)


def _conductances(seed, shape=(96, 80)):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(0.01), np.log(150.0), shape)).astype(
        np.float32)


def test_sigmas_and_threshold_transfer_match_repro():
    """exp and log each round up to an ulp apart between XLA and PyTorch.
    One ulp of log(g) (|log g| <= 5, an ulp of 2^-21) moves exp's
    argument a * log(g) + b by up to 2^-22 + half an ulp of the sum, that
    is up to ~8 ulps of the result, plus exp's own ulp: within 16 ulps
    (measured up to 7)."""
    g = _conductances(0)
    for model in (noise.DEFAULT, noise.DEFAULT.rescale(2.0)):
        j_model = j_noise.NoiseModel(scale=model.scale)
        for name in ("sigma_prog", "sigma_fluct", "threshold_of_g"):
            mine = getattr(model, name)(torch.from_numpy(g)).numpy()
            ref = np.asarray(getattr(j_model, name)(jnp.asarray(g)))
            assert _ulps(mine, ref).max() <= 16, name
    # the inverse divides log(t - c) by a_acam = 0.3, which amplifies log's
    # ulp 3.3x in exp's argument: within 32 u relative (measured 18 u)
    th = noise.DEFAULT.threshold_of_g(torch.from_numpy(g))
    mine = noise.DEFAULT.g_of_threshold(th).numpy()
    ref = np.asarray(j_noise.DEFAULT.g_of_threshold(jnp.asarray(th.numpy())))
    np.testing.assert_allclose(mine, ref, rtol=32 * U32)


@pytest.mark.parametrize("seed", [0, 3])
def test_program_read_readout_match_repro(seed):
    """One Eq 6 event per cell from the same key: the same normals (within
    their ulps) scaled by the same sigmas, so each conductance within
    2^-20 (~1e-6) relative of the reference's — a few ulps of the cell."""
    g = _conductances(seed)
    jk, tk = _jkey(seed), prng.prng_key(seed)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    m, jm = noise.DEFAULT, j_noise.DEFAULT
    for mine, ref in ((m.program(tk, tg), jm.program(jk, jg)),
                      (m.read(tk, tg), jm.read(jk, jg)),
                      (m.readout(tk, tg), jm.readout(jk, jg)),
                      (noise.noisy_weight(tk, tg / 150, 1.0, m),
                       j_noise.noisy_weight(jk, jg / 150, 1.0, jm))):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                   rtol=2.0 ** -20, atol=1e-9)
    np.testing.assert_array_equal(noise.IDEAL.readout(tk, tg).numpy(), g)


@pytest.mark.parametrize("rate", [0.01, 0.3])
def test_stuck_at_faults_match_repro_bitwise(rate):
    g = _conductances(5)
    out, mask = noise.stuck_at_faults(prng.prng_key(4), torch.from_numpy(g),
                                      rate)
    j_out, j_mask = j_noise.stuck_at_faults(_jkey(4), jnp.asarray(g), rate)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    _bits_equal(out.numpy(), j_out)
    assert 0 < mask.numpy().mean() < 2 * rate


# -- A-SL programming and the crossbar -----------------------------------

def _weight(seed, k=64, n=48):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)


def _cells(plan):
    return [np.asarray(c) for c in (plan.g_pos_main, plan.g_neg_main,
                                    plan.g_pos_res, plan.g_neg_res)]


@pytest.mark.parametrize("seed", [0, 1])
def test_ideal_program_linear_cells_bitwise(seed):
    """The host-float ``w_max`` route: ``g_ratio`` in doubles rounded once,
    true float32 divisions — every cell equal to ``repro``'s."""
    w = _weight(seed)
    plan, eps = crossbar.program_linear(torch.from_numpy(w))
    j_plan, j_eps = j_crossbar.program_linear(jnp.asarray(w))
    assert isinstance(plan.w_max, float) and plan.w_max == j_plan.w_max
    for got, want in zip(plan.cells, _cells(j_plan)):
        _bits_equal(got.numpy(), want)
    _bits_equal(eps.numpy(), j_eps)


def test_zero_weight_programs_at_unit_w_max():
    plan, _ = crossbar.program_linear(torch.zeros((4, 3)))
    assert plan.w_max == 1.0


def test_noisy_program_linear_matches_repro():
    """``prog_rng`` split four ways, one key per cell matrix.  Main cells
    within 2^-20 relative of the reference's (normals within their ulps,
    sigmas within 16 ulps).  A residual cell is programmed to 10x the main
    pair's error in conductance units, so it inherits 2 x 10 times the
    main cells' largest difference (plus its own 2^-20 relative)."""
    w = _weight(2)
    plan, eps = crossbar.program_linear(torch.from_numpy(w),
                                        rng=prng.prng_key(1))
    j_plan, j_eps = j_crossbar.program_linear(jnp.asarray(w),
                                              rng=_jkey(1))
    got, want = [c.numpy() for c in plan.cells], _cells(j_plan)
    for i in (0, 1):
        np.testing.assert_allclose(got[i], want[i], rtol=2.0 ** -20,
                                   atol=1e-9)
    main = max(np.abs(got[i] - want[i]).max() for i in (0, 1))
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=2.0 ** -20,
                                   atol=2 * slicing.RESIDUAL_GAIN * main)
    np.testing.assert_allclose(eps.numpy(), np.asarray(j_eps), atol=1e-6)
    assert eps.max() > 1e-4                    # the noise is really there


@pytest.mark.parametrize("saf_rate", [0.0, 0.01])
def test_effective_weight_matches_repro(saf_rate):
    """A fresh read per cell (``split(rng, 4)``), faults keyed
    ``fold_in(key, 7)``: the fault masks are bitwise, so W_eff agrees to
    float32 rounding of the reads (1e-6 absolute on weights ~0.1)."""
    w = _weight(3)
    plan, _ = crossbar.program_linear(torch.from_numpy(w),
                                      rng=prng.prng_key(2))
    j_plan, _ = j_crossbar.program_linear(jnp.asarray(w), rng=_jkey(2))
    mine = slicing.effective_weight(plan, prng.prng_key(6),
                                    saf_rate=saf_rate).numpy()
    ref = np.asarray(j_slicing.effective_weight(j_plan, _jkey(6),
                                                saf_rate=saf_rate))
    np.testing.assert_allclose(mine, ref, atol=1e-6)
    ideal = slicing.effective_weight(plan).numpy()
    np.testing.assert_allclose(
        ideal, np.asarray(j_slicing.effective_weight(j_plan)), atol=1e-7)


@pytest.mark.parametrize("dac_slices,saf_rate", [(1, 0.0), (1, 0.01),
                                                  (2, 0.0), (2, 0.01)])
def test_crossbar_vmm_matches_repro(dac_slices, saf_rate):
    """The fused path (``dac_slices`` 1) and one analog pass per input bit
    slice (2, keys ``fold_in(rng, s)``) with an 8-bit input DAC: outputs
    within 2 K u of sum |x||W| plus the reads' 1e-6 per weight."""
    w = _weight(4)
    x = np.random.default_rng(5).normal(size=(7, w.shape[0])).astype(
        np.float32)
    plan, _ = crossbar.program_linear(torch.from_numpy(w),
                                      rng=prng.prng_key(3))
    j_plan, _ = j_crossbar.program_linear(jnp.asarray(w), rng=_jkey(3))
    kw, j_kw = {}, {}
    if dac_slices > 1:
        kw = dict(input_spec=QuantSpec(-3.0, 3.0, 8))
        j_kw = dict(input_spec=JQuantSpec(-3.0, 3.0, 8))
    mine = crossbar.crossbar_vmm(torch.from_numpy(x), plan, prng.prng_key(8),
                                 dac_slices=dac_slices, saf_rate=saf_rate,
                                 **kw).numpy()
    ref = np.asarray(j_crossbar.crossbar_vmm(
        jnp.asarray(x), j_plan, _jkey(8), dac_slices=dac_slices,
        saf_rate=saf_rate, **j_kw))
    k = w.shape[0]
    xs = np.abs(x) if dac_slices == 1 else np.full_like(x, 3.0)
    # |W_eff| <= |w| + 1e-2 of noise; each read weight within 1e-6
    bound = (xs @ (np.abs(w) + 1e-2) * (2 * k * U32)
             + xs.sum(1, keepdims=True) * 1e-6)
    assert (np.abs(mine - ref) <= bound).all()


def test_ideal_vmm_matches_repro():
    w, x = _weight(6), np.random.default_rng(7).normal(size=(5, 64)).astype(
        np.float32)
    spec, j_spec = QuantSpec(-2.0, 2.0, 8), JQuantSpec(-2.0, 2.0, 8)
    mine = crossbar.ideal_vmm(torch.from_numpy(x), torch.from_numpy(w),
                              spec).numpy()
    ref = np.asarray(j_crossbar.ideal_vmm(jnp.asarray(x), jnp.asarray(w),
                                          j_spec))
    np.testing.assert_allclose(mine, ref, atol=2 * 64 * U32 * 2 * 2)
