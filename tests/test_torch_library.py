"""The port's public NL-DPE kernel library on the CPU: the plain versions
of kernels D (``acam_apply``), E (``crossbar_matmul``) and G
(``nldpe_matmul_int8``), and the core entry points around them, held
against ``repro``'s oracles (``use_ref=True``) and its Pallas kernels in
interpret mode.

Tolerances, each stated at its assertion:

* bitwise — the ACAM interval match against ``repro``'s oracle and
  ``eval_acam``, ``encode_int8``;
* ACAM values against ``repro``'s jitted Pallas kernel: equal codes, the
  value within one rounding of ``code * step + lo`` (XLA contracts it into
  an FMA under ``jit``; the port and ``repro``'s eager oracle round the
  product and the sum apart — ROADMAP §C);
* GEMM outputs — two float32 sum orders, (2 K + slack) u per output of
  the summed term magnitudes, u = 2^-24.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acam as j_acam
from repro.core import logdomain as j_logdomain
from repro.core.logdomain import DEFAULT_CFG as J_CFG
from repro.core.slicing import SlicedWeights as JSlicedWeights
from repro.kernels.acam_activation.ops import acam_apply as j_acam_apply
from repro.kernels.crossbar_vmm.ops import crossbar_matmul as j_crossbar_matmul
from repro.kernels.nldpe_qmatmul.ops import encode_int8 as j_encode_int8
from repro.kernels.nldpe_qmatmul.ops import (
    nldpe_matmul_int8 as j_nldpe_matmul_int8)

import repro_torch.kernels as kernels
from repro_torch import quickstart
from repro_torch.core import acam, dt, logdomain
from repro_torch.core.crossbar import program_linear
from repro_torch.core.logdomain import DEFAULT_CFG
from repro_torch.kernels.acam_activation.ops import acam_apply
from repro_torch.kernels.crossbar_vmm.ops import crossbar_matmul, crossbar_vmm
from repro_torch.kernels.nldpe_qmatmul.ops import (encode_int8,
                                                   nldpe_matmul_int8,
                                                   nldpe_qmatmul)
from repro_torch.kernels.nldpe_qmatmul.ref import dequant_ref
from repro_torch.launch import prng

torch.set_num_threads(1)

U32 = 2.0 ** -24
FUNCTIONS = ["gelu", "silu", "exp", "log"]


def _inputs(name, shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape) * 4
    if name == "log":
        x = np.abs(x) + 1e-3
    return x.astype(np.float32)


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.int32),
                                  np.asarray(b, np.float32).view(np.int32))


# -- kernel D: acam_apply -------------------------------------------------

@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("shape", [(3, 1000, 7), (77,), (1, 1)])
def test_acam_apply_matches_repro_oracle_bitwise(name, shape):
    """Ragged sizes (none a multiple of 1024): bitwise against ``repro``'s
    ``acam_apply(use_ref=True)`` and against ``eval_acam``."""
    x = _inputs(name, shape)
    table = acam.get_table(name, 8)
    mine = acam_apply(torch.from_numpy(x), table).numpy()
    j_table = j_acam.get_table(name, 8)
    _bits_equal(mine, j_acam_apply(jnp.asarray(x), j_table, use_ref=True))
    _bits_equal(mine, j_acam.eval_acam(j_table, jnp.asarray(x)))
    assert mine.shape == shape and mine.dtype == np.float32


@pytest.mark.parametrize("name", FUNCTIONS)
def test_acam_apply_bf16_input_matches_repro_bitwise(name):
    """A bf16 input is upcast to float32 first (as ``repro``'s kernel path
    does); the float32 output is bitwise ``repro``'s oracle on the upcast
    values."""
    xb = torch.from_numpy(_inputs(name, (13, 29), 1)).to(torch.bfloat16)
    table = acam.get_table(name, 8)
    mine = acam_apply(xb, table).numpy()
    up = xb.to(torch.float32).numpy()
    _bits_equal(mine, j_acam_apply(jnp.asarray(up), j_acam.get_table(name, 8),
                                   use_ref=True))
    assert mine.dtype == np.float32 and mine.shape == (13, 29)


@pytest.mark.parametrize("name", ["silu", "log"])
def test_acam_apply_matches_repro_pallas_codes(name):
    """``repro``'s Pallas kernel in interpret mode: the same ACAM codes;
    the value within one rounding of ``code * step + lo`` — XLA fuses the
    multiply-add under ``jit`` where the port (B's epilogue, D, the plain
    versions) rounds the product first, 2^-23 (|code * step| + |value|)."""
    x = _inputs(name, (3, 1000, 7), 2)
    table = acam.get_table(name, 8)
    step, lo = float(table.out_spec.step), float(table.out_spec.lo)
    mine = acam_apply(torch.from_numpy(x), table).numpy()
    ref = np.asarray(j_acam_apply(jnp.asarray(x), j_acam.get_table(name, 8),
                                  interpret=True))
    codes = np.rint((mine.astype(np.float64) - lo) / step)
    np.testing.assert_array_equal(codes, np.rint((ref - lo) / step))
    tol = 2.0 ** -23 * (np.abs(codes * step) + np.abs(ref))
    assert (np.abs(mine - ref) <= tol).all()


def test_eval_acam_matches_repro_bitwise():
    """Default and caller-given (perturbed) thresholds, Gray and binary
    encodings."""
    x = _inputs("gelu", (4, 128), 3)
    for encoding in ("gray", "binary"):
        table = dt.build_table("gelu", bits=8, encoding=encoding)
        j_table = j_acam.build_table("gelu", bits=8, encoding=encoding)
        _bits_equal(acam.eval_acam(table, torch.from_numpy(x)).numpy(),
                    j_acam.eval_acam(j_table, jnp.asarray(x)))
        lo = table.lo + np.float32(0.01)
        _bits_equal(acam.eval_acam(table, torch.from_numpy(x),
                                   lo=torch.from_numpy(lo)).numpy(),
                    j_acam.eval_acam(j_table, jnp.asarray(x),
                                     lo=jnp.asarray(lo)))


# -- kernel G: the int8 log-domain DMMul -----------------------------------

def _dmmul_operand(rng, shape):
    """Magnitudes log-uniform over the DMMul grid [1e-4, 16] and a bit
    beyond, random signs, 5% exact zeros (sign 0)."""
    mag = np.exp(rng.uniform(np.log(3e-5), np.log(20.0), shape))
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    return (mag * sign * (rng.random(shape) >= 0.05)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_int8_matches_repro_bitwise(dtype):
    x = torch.from_numpy(_dmmul_operand(np.random.default_rng(0), (40, 70))
                         ).to(dtype)
    code, sign = encode_int8(x)
    j_x = jnp.asarray(x.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    j_code, j_sign = j_encode_int8(j_x)
    assert code.dtype == sign.dtype == torch.int8
    np.testing.assert_array_equal(code.numpy(), np.asarray(j_code))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(j_sign))
    assert (sign == 0).any() and (sign == -1).any()


def _within_sum_order(mine, ref, a_abs, b_abs, slack_u=8):
    """|mine - ref| <= (2 K + slack_u) u (|A| @ |B|): two float32 GEMMs in
    different sum orders (2 K u, the worst case of two length-K dot
    products), ``slack_u`` u per product for operands a few ulps apart."""
    k = a_abs.shape[-1]
    tol = (a_abs.astype(np.float64) @ b_abs) * ((2 * k + slack_u) * U32)
    return bool((np.abs(np.asarray(mine, np.float64) - ref) <= tol).all())


@pytest.mark.parametrize("m,k,n", [(13, 70, 9), (130, 129, 5), (1, 300, 2)])
def test_nldpe_matmul_int8_matches_repro(m, k, n):
    """Ragged M/N/K with dead values: against ``repro``'s oracle and (one
    shape) its Pallas kernel in interpret mode.  The dequantized operands
    agree up to exp's ulp (the port rounds ``code * step + log_lo`` once,
    as the jitted kernel does): slack 8 u."""
    rng = np.random.default_rng(m + k + n)
    a, b = _dmmul_operand(rng, (m, k)), _dmmul_operand(rng, (k, n))
    mine = nldpe_matmul_int8(torch.from_numpy(a), torch.from_numpy(b))
    spec = DEFAULT_CFG.mag_spec
    (ac, as_), (bc, bs) = (encode_int8(torch.from_numpy(t)) for t in (a, b))
    da = dequant_ref(ac, as_, spec.step, spec.log_lo).abs().numpy()
    db = dequant_ref(bc, bs, spec.step, spec.log_lo).abs().numpy()
    ref = np.asarray(j_nldpe_matmul_int8(jnp.asarray(a), jnp.asarray(b),
                                         use_ref=True))
    assert _within_sum_order(mine.numpy(), ref, da, db)
    if m == 13:
        ref = np.asarray(j_nldpe_matmul_int8(jnp.asarray(a), jnp.asarray(b),
                                             interpret=True))
        assert _within_sum_order(mine.numpy(), ref, da, db)


def test_dequant_rounds_like_repro_jitted_kernel():
    """The plain G dequant's exp argument, ``(code + 128) * step +
    log_lo``, equals what XLA computes under ``jit`` for all 256 codes:
    one fused rounding (121 of the 256 differ from two roundings)."""
    spec = DEFAULT_CFG.mag_spec
    codes = torch.arange(-128, 128, dtype=torch.int64)
    arg = ((codes.to(torch.float64) + 128) * float(np.float32(spec.step))
           + float(np.float32(spec.log_lo))).to(torch.float32).numpy()
    j_arg = np.asarray(jax.jit(lambda c: c * J_CFG.mag_spec.step
                               + J_CFG.mag_spec.log_lo)(
        jnp.arange(256, dtype=jnp.float32)))
    _bits_equal(arg, j_arg)
    twice = (np.arange(256, dtype=np.float32) * np.float32(spec.step)
             ).astype(np.float32) + np.float32(spec.log_lo)
    assert (twice != j_arg).sum() > 100


@pytest.mark.parametrize("mode", ["fused", "exact"])
def test_nldpe_matmul_matches_repro(mode):
    """Batched (2, M, K) @ (2, K, N) with dead values, ``block_k`` 32:
    both modes within the float32 sum-order bound of the summed
    magnitudes (exact mode sums its 8-bit products; fused mode's decode
    rounds through exp, one ulp apart between XLA and PyTorch)."""
    rng = np.random.default_rng(9)
    a, b = _dmmul_operand(rng, (2, 13, 70)), _dmmul_operand(rng, (2, 70, 9))
    mine = logdomain.nldpe_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                  mode=mode, block_k=32).numpy()
    ref = np.asarray(j_logdomain.nldpe_matmul(
        jnp.asarray(a), jnp.asarray(b), mode=mode, block_k=32))
    if mode == "exact":
        # each product is an 8-bit exp-grid value of at most 256
        mags = (np.abs(a) > 0).astype(np.float32) * 256.0, \
            (np.abs(b) > 0).astype(np.float32)
    else:
        mags = np.abs(a) * 1.05, np.abs(b) * 1.05
    for i in range(2):
        assert _within_sum_order(mine[i], ref[i], mags[0][i], mags[1][i])
    with pytest.raises(ValueError):
        logdomain.nldpe_matmul(torch.ones(2, 2), torch.ones(2, 2),
                               mode="nope")


def test_nldpe_mul_exact_matches_repro():
    """Element-wise, each product re-quantized on the 8-bit exp grid: an
    exp an ulp apart could move a product across a rounding edge of that
    grid — one step, on at most one element; measured none."""
    rng = np.random.default_rng(10)
    a, b = _dmmul_operand(rng, (5000,)), _dmmul_operand(rng, (5000,))
    mine = logdomain.nldpe_mul(torch.from_numpy(a), torch.from_numpy(b),
                               mode="exact").numpy()
    ref = np.asarray(j_logdomain.nldpe_mul(jnp.asarray(a), jnp.asarray(b),
                                           mode="exact"))
    step = DEFAULT_CFG.exp_out_spec().step
    assert np.abs(mine - ref).max() <= step * 1.0001
    assert (mine != ref).sum() <= 1
    mine, ref = DEFAULT_CFG.exp_out_spec(), J_CFG.exp_out_spec()
    assert (mine.lo, mine.hi, mine.bits) == (ref.lo, ref.hi, ref.bits)


# -- kernel E: crossbar_matmul --------------------------------------------

def _plan_pair(seed, k, n, noisy):
    """The port's plan (programming noise when ``noisy``) and the same
    cells handed to ``repro`` as its plan."""
    w = (np.random.default_rng(seed).normal(size=(k, n)) * k ** -0.5
         ).astype(np.float32)
    plan, _ = program_linear(torch.from_numpy(w),
                             rng=prng.prng_key(seed) if noisy else None)
    j_plan = JSlicedWeights(*(jnp.asarray(c.numpy()) for c in plan.cells),
                            w_max=plan.w_max)
    return plan, j_plan


def _term_magnitudes(plan):
    """|G+| + |G-| + (|G+res| + |G-res|) / 10, times inv: what W_eff sums
    before its cancellations, the scale of its rounding."""
    gp, gn, rp, rn = (c.abs() for c in plan.cells)
    inv = 1.0 / ((150.0 - 0.01) / plan.w_max)
    return ((gp + gn + (rp + rn) / 10) * inv).numpy()


@pytest.mark.parametrize("m,k,n", [(5, 40, 24), (16, 130, 70)])
def test_crossbar_matmul_matches_repro_ideal_read(m, k, n):
    """``rng=None``, the same cells: against ``repro``'s oracle and its
    Pallas kernel in interpret mode (cells padded with g_min), within
    (2 K + 8) u of sum |x| (W_eff's term magnitudes) — W_eff itself
    rounds ``/ 10`` against ``* f32(0.1)`` and maybe an FMA."""
    plan, j_plan = _plan_pair(m, k, n, noisy=True)
    x = np.random.default_rng(1).normal(size=(m, k)).astype(np.float32)
    mine = crossbar_matmul(torch.from_numpy(x), plan).numpy()
    mags = _term_magnitudes(plan)
    for kw in ({"use_ref": True}, {"interpret": True}):
        ref = np.asarray(j_crossbar_matmul(jnp.asarray(x), j_plan, **kw))
        assert _within_sum_order(mine, ref, np.abs(x), mags)


def test_crossbar_matmul_matches_repro_with_read_noise():
    """``rng`` given: the read noise is drawn outside the kernel with
    ``split(rng, 4)``, normals within their ulps, so each read cell is
    within 2^-20 relative of the reference's; on top of the sum-order
    bound, 4 cells x 2^-20 x g_max x inv per weight."""
    m, k, n = 9, 100, 37
    plan, j_plan = _plan_pair(3, k, n, noisy=False)
    x = np.random.default_rng(2).normal(size=(m, k)).astype(np.float32)
    mine = crossbar_matmul(torch.from_numpy(x), plan,
                           rng=prng.prng_key(4)).numpy()
    ref = np.asarray(j_crossbar_matmul(jnp.asarray(x), j_plan,
                                       rng=jax.random.PRNGKey(4),
                                       use_ref=True))
    inv = 1.0 / ((150.0 - 0.01) / plan.w_max)
    mags = _term_magnitudes(plan) + 4 * 2.0 ** -20 * 150.0 * inv
    assert _within_sum_order(mine, ref, np.abs(x), mags)
    ideal = crossbar_matmul(torch.from_numpy(x), plan).numpy()
    assert np.abs(mine - ideal).max() > 1e-4     # the read noise is there


def test_crossbar_matmul_needs_host_w_max():
    """A plan whose ``w_max`` is a device tensor (the fused serve path's)
    has no host ``inv``: rejected, as ``repro``'s static argument is."""
    plan, _ = _plan_pair(5, 8, 4, noisy=False)
    plan.w_max = torch.tensor(plan.w_max)
    with pytest.raises(TypeError):
        crossbar_matmul(torch.ones((2, 8)), plan)


# -- the library as a whole -------------------------------------------------

def test_cpu_tensors_never_launch():
    wrappers = (acam_apply, crossbar_vmm, nldpe_qmatmul)
    before = [w.launches for w in wrappers]
    acam_apply(torch.ones((3, 5)), acam.get_table("silu", 8))
    plan, _ = _plan_pair(6, 8, 4, noisy=False)
    crossbar_matmul(torch.ones((2, 8)), plan, rng=prng.prng_key(0))
    nldpe_matmul_int8(torch.ones((2, 8)), torch.ones((8, 3)))
    assert [w.launches for w in wrappers] == before


def test_library_exports_match_repro():
    """``repro_torch.kernels`` exports the library ``repro.kernels`` does
    (its ``resolve_interpret``/``divisor_block`` helpers aside)."""
    import repro.kernels as j_kernels
    for name in ("acam_apply", "crossbar_matmul", "nldpe_matmul_int8",
                 "fused_crossbar_acam", "fused_linear_acam",
                 "logdomain_flash_attention", "flash_attention",
                 "paged_attention"):
        assert callable(getattr(j_kernels, name))
        assert callable(getattr(kernels, name))
    assert kernels.encode_int8 is encode_int8
    for src in ("acam_activation", "crossbar_vmm", "nldpe_qmatmul"):
        assert src in kernels.build.SOURCES


def test_quickstart_runs_on_cpu():
    """Sections 1, 2 and the A-SL section on the CPU: the kernel-D GELU is
    the interval match bit for bit, the errors are the reference
    quickstart's where it has them (GELU MSE 8.29e-05, fused DMMul
    relative MSE 3.59e-04)."""
    out = quickstart.main(device="cpu")
    assert torch.equal(out["gelu"]["kernel"], out["gelu"]["interval"])
    assert math.isclose(out["gelu_interval_mse"], 8.29e-05, rel_tol=1e-2)
    assert math.isclose(out["dmmul_fused_rel_mse"], 3.59e-04, rel_tol=1e-2)
    assert out["dmmul_kernel_rel_mse"] == pytest.approx(
        out["dmmul_fused_rel_mse"], rel=1e-4)
    assert 0 < out["asl_rel_mse"] < 1e-3
