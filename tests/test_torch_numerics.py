"""The port's NL-DPE numerics held against ``repro``'s on identical inputs.

Comparison levels (ROADMAP North star):

* bitwise — ACAM tables (also against ``tests/golden``), the interval
  match, the Gray decode and the piecewise fast path;
* log-grid codes — at most 1 LSB apart, on a stated small share of
  inputs: ``repro`` runs under ``jit``, where XLA fuses ``code*step+lo``
  into an FMA and rewrites division by a constant as a multiplication,
  while PyTorch runs each op on its own;
* the A-SL programming of the fused crossbar path — bitwise against
  ``repro``'s eager ops, which is how ``fused_linear_acam`` programs.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acam as j_acam
from repro.core import dt as j_dt
from repro.core import logdomain as j_ld
from repro.core.attention import nldpe_attention as j_nldpe_attention
from repro.core.noise import DEFAULT as J_DEFAULT
from repro.core.slicing import plan_asl as j_plan_asl

from golden.make_goldens import GOLDEN_CASES, case_path
from repro_torch.core import acam, dt, logdomain
from repro_torch.core.attention import nldpe_attention
from repro_torch.core.quantization import QuantSpec
from repro_torch.kernels.dual_compute.ops import program

torch.set_num_threads(1)

GOLDEN_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "golden")
CFG = logdomain.DEFAULT_CFG
MAG_STEP = CFG.mag_spec.step


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "case", GOLDEN_CASES,
    ids=[f"{c['fn']}-b{c['bits']}-{c['encoding']}" for c in GOLDEN_CASES])
def test_port_tables_match_golden(case):
    want = np.load(case_path(case, GOLDEN_ROOT))
    t = dt.build_table(case["fn"], bits=case["bits"],
                       encoding=case["encoding"], dense=case["dense"])
    got = dict(lo=t.lo, hi=t.hi,
               rows_per_bit=np.asarray(t.rows_per_bit, np.int64),
               in_domain=np.asarray(t.in_domain, np.float64),
               out_lo=np.float64(t.out_spec.lo),
               out_hi=np.float64(t.out_spec.hi),
               out_bits=np.int64(t.out_spec.bits))
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", ["silu", "gelu", "sigmoid"])
def test_port_serving_tables_match_repro(name):
    """The 8-bit Gray tables the serve path programs, bit for bit."""
    mine, ref = acam.get_table(name, 8), j_acam.get_table(name, 8)
    np.testing.assert_array_equal(mine.lo, ref.lo)
    np.testing.assert_array_equal(mine.hi, ref.hi)
    assert mine.rows_per_bit == ref.rows_per_bit
    assert (mine.out_spec.lo, mine.out_spec.step) == \
        (ref.out_spec.lo, ref.out_spec.step)


def _acam_inputs(table, n=20000, seed=0):
    """Random pre-activations plus every interval edge and its float32
    neighbours, where a match flips."""
    rng = np.random.default_rng(seed)
    edges = np.concatenate([table.lo.ravel(), table.hi.ravel()])
    edges = edges[np.abs(edges) < 1e29].astype(np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))])
    x = np.concatenate([rng.normal(0, 3, n).astype(np.float32), near])
    return x


@pytest.mark.parametrize("name", ["silu", "exp"])
def test_plain_acam_bitwise(name):
    """Interval match, Gray decode and the dequantized value equal
    ``repro``'s on identical pre-activations (eager ops on both sides)."""
    table = acam.get_table(name, 8)
    x = _acam_inputs(table)
    lo, hi = acam.table_thresholds(table, "cpu")
    jlo, jhi = jnp.asarray(table.lo), jnp.asarray(table.hi)
    g = acam.match_bits(lo, hi, _t(x))
    jg = j_acam.match_bits(jlo, jhi, jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(acam.gray_decode_bits(g).numpy(),
                                  np.asarray(j_acam.gray_decode_bits(jg)))
    out = acam.eval_table(lo, hi, _t(x), float(table.out_spec.lo),
                          float(table.out_spec.step))
    ref = j_acam.eval_table(jlo, jhi, jnp.asarray(x),
                            float(table.out_spec.lo),
                            float(table.out_spec.step))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_plain_acam_equals_kernel_reference():
    """The same against the fused kernel's own oracle
    (``kernels/acam_activation/ref.py``)."""
    from repro.kernels.acam_activation.ref import acam_activation_ref
    table = acam.get_table("silu", 8)
    x = _acam_inputs(table, seed=1)
    lo, hi = acam.table_thresholds(table, "cpu")
    out = acam.eval_table(lo, hi, _t(x), float(table.out_spec.lo),
                          float(table.out_spec.step))
    ref = acam_activation_ref(jnp.asarray(x), jnp.asarray(table.lo),
                              jnp.asarray(table.hi), 8,
                              float(table.out_spec.lo),
                              float(table.out_spec.step))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_piecewise_activation_bitwise(dtype):
    """The ``ON`` numerics' ACAM activation (sorted-breakpoint search)."""
    table = acam.get_table("silu", 8)
    x = _acam_inputs(table, seed=2)
    tx = _t(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    out = acam.acam_activation(tx, "silu").float().numpy()
    ref = np.asarray(jax.jit(lambda v: j_acam.acam_activation(v, "silu"))(
        jx).astype(jnp.float32))
    np.testing.assert_array_equal(out, ref)


def _log_codes(v, floor):
    """Log-grid code index of reconstructed values (0-flushes -> -1)."""
    a = np.abs(np.asarray(v, np.float64))
    return np.where(a < floor, -1,
                    np.round((np.log(np.maximum(a, floor))
                              - CFG.mag_spec.log_lo) / MAG_STEP))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_log_quantize_within_one_lsb(dtype):
    """2M values: codes at most 1 LSB apart from ``repro`` under jit, on at
    most 1 in 10^5 values (ROADMAP.md records 1 in 2M for a port that
    divides naively; this one measures 0), signs and flushes identical."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(2_000_000)
         * np.exp(rng.uniform(-10, 3, 2_000_000))).astype(np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    out = logdomain.log_quantize(tx).numpy()
    ref = np.asarray(jax.jit(j_ld.log_quantize)(jx), np.float32)
    np.testing.assert_array_equal(np.sign(out), np.sign(ref))
    floor = math.exp(CFG.mag_spec.log_lo) * 0.5
    dc = np.abs(_log_codes(out, floor) - _log_codes(ref, floor))
    assert dc.max() <= 1
    assert (dc > 0).sum() <= 20, f"{(dc > 0).sum()} codes flipped in 2M"
    # same code: the reconstruction differs only where XLA's FMA of
    # code*step+log_lo rounds the exp argument (|arg| < 10) one ulp apart,
    # ~1e-6 relative after exp
    same = dc == 0
    np.testing.assert_allclose(out[same], ref[same], rtol=2e-6, atol=0)


def test_quantspec_codes_match_repro():
    """The softmax grids' QuantSpec codes (float32): bitwise."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-9, 1, 1_000_000).astype(np.float32)
    spec = QuantSpec(lo=-8.0, hi=0.0, bits=8)
    from repro.core.quantization import QuantSpec as JQuantSpec
    jspec = JQuantSpec(lo=-8.0, hi=0.0, bits=8)
    np.testing.assert_array_equal(
        spec.quantize(_t(x)).numpy(),
        np.asarray(jax.jit(jspec.quantize)(jnp.asarray(x))))


def test_nldpe_mul_within_one_lsb():
    """Element-wise DMMul (the MLP gate * up product), bf16 operands as on
    the serve path: each product within one log-grid step of each
    operand's rounding, i.e. |out/ref - 1| <= e^(2*step) - 1."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal(500_000).astype(np.float32)
    b = rng.standard_normal(500_000).astype(np.float32)
    ta, tb = (_t(v).to(torch.bfloat16) for v in (a, b))
    ja, jb = (jnp.asarray(v).astype(jnp.bfloat16) for v in (a, b))
    out = logdomain.nldpe_mul(ta, tb).numpy()
    ref = np.asarray(jax.jit(j_ld.nldpe_mul)(ja, jb), np.float32)
    np.testing.assert_array_equal(out == 0, ref == 0)
    nz = ref != 0
    rel = np.abs(out[nz] / ref[nz] - 1)
    assert rel.max() <= math.expm1(2 * MAG_STEP) * 1.0001
    # a code flip moves a product by >= e^step - 1 (~5%); everything else
    # is the exp-argument rounding of each operand (~1e-6 relative each)
    assert (rel > 1e-5).mean() <= 1e-5


def test_nldpe_attention_within_one_lsb():
    """NL-DPE attention over a masked cache view: the log-softmax codes
    within 1 LSB of ``repro``'s, and each output within the error one LSB
    of each grid can make, relative to the row's |weights| @ |V| mass."""
    rng = np.random.default_rng(3)
    b, h, lq, lk, d = 2, 2, 5, 24, 16
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    mask = rng.random((b, 1, lq, lk)) < 0.8
    mask[..., 0] = True
    out = nldpe_attention(_t(q), _t(k), _t(v), causal=False,
                          mask=_t(mask)).numpy()
    ref = np.asarray(jax.jit(lambda *a: j_nldpe_attention(
        *a, causal=False, mask=jnp.asarray(mask)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    mass = np.abs(ref).max() + np.abs(v).max()
    step = 2 * CFG.score_range / 255
    assert np.abs(out - ref).max() <= math.expm1(step + MAG_STEP) * mass


def test_asl_programming_bitwise():
    """``program`` (ideal A-SL cells, w_max on the device) equals
    ``repro``'s eager ``plan_asl``; inv_g_ratio is the jit form."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((64, 96)) * 0.1).astype(np.float32)
    cells, inv = program(_t(w))
    jw = jnp.asarray(w)
    w_max = jnp.maximum(jnp.max(jnp.abs(jw)), 1e-9)
    plan, _ = j_plan_asl(jw, w_max, J_DEFAULT, prog_rng=None)
    ref = [plan.g_pos_main, plan.g_neg_main, plan.g_pos_res, plan.g_neg_res]
    for got, want in zip(cells, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jinv = jax.jit(lambda m: m / (J_DEFAULT.g_max - J_DEFAULT.g_min))(w_max)
    assert inv.item() == float(jinv)
