"""The exact compile of an ACAM unit (``core.acam.compile_thresholds``),
the map kernels B and D search, on the CPU: its search
(``eval_compiled``) against the port's row walk ``eval_table`` and
``repro``'s ``eval_acam`` (the reference oracle), bit for bit.

Inputs: random values, every breakpoint and both float32 neighbours of
each, NaN, +-inf, +-1e30 and +-FLT_MAX, and bf16 values upcast; tables
silu, gelu, exp and log, with their own thresholds and with thresholds
moved by a seeded normal (sigma 0.01), compiled with and without
dropping repeated breakpoints.  Tolerance: bitwise everywhere — the
compile evaluates the same compares and the same two float32 roundings.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import acam as j_acam

from repro_torch.core import acam

torch.set_num_threads(1)

FUNCTIONS = ["silu", "gelu", "exp", "log"]
F32_MAX = float(np.finfo(np.float32).max)
SPECIALS = [np.nan, np.inf, -np.inf, 1e30, -1e30, F32_MAX, -F32_MAX, 0.0,
            -0.0]


def _thresholds(name, noisy, seed=0):
    table = acam.get_table(name, 8)
    lo, hi = table.lo, table.hi
    if noisy:
        rng = np.random.default_rng(seed)
        lo = (lo + rng.normal(0, 0.01, lo.shape)).astype(np.float32)
        hi = (hi + rng.normal(0, 0.01, hi.shape)).astype(np.float32)
    return table, torch.from_numpy(lo), torch.from_numpy(hi)


def _probe(bp, seed=0, scale=4.0, n=20000):
    """Random values, every breakpoint, both float32 neighbours of each
    finite one, and the special values."""
    bp = bp.numpy()
    fin = bp[np.isfinite(bp)]
    rand = np.random.default_rng(seed).normal(size=n) * scale
    with np.errstate(over="ignore"):                # FLT_MAX's neighbour
        up = np.nextafter(fin, np.float32(np.inf))
        down = np.nextafter(fin, np.float32(-np.inf))
    return torch.from_numpy(np.concatenate([
        rand.astype(np.float32), bp, up, down,
        np.asarray(SPECIALS, np.float32)]).astype(np.float32))


def _bits(t):
    return np.asarray(t, np.float32).view(np.int32)


def _grid(table):
    return float(table.out_spec.lo), float(table.out_spec.step)


@pytest.mark.parametrize("unique", [False, True], ids=["all", "unique"])
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_compiled_search_equals_row_walk_and_repro(name, noisy, unique):
    """Bitwise: the compiled map's search against the port's walk and
    ``repro``'s ``eval_acam`` with the same (noisy) thresholds."""
    table, lo, hi = _thresholds(name, noisy)
    m = acam.compile_thresholds(lo, hi, unique=unique)
    n = m.breakpoints.shape[0]
    assert m.codes.shape == (2 * n + 1,) and m.codes.dtype == torch.int32
    assert bool((m.breakpoints[1:] >= m.breakpoints[:-1]).all())
    x = _probe(m.breakpoints, seed=int(noisy))
    mine = acam.eval_compiled(m, x, *_grid(table))
    np.testing.assert_array_equal(_bits(mine),
                                  _bits(acam.eval_table(lo, hi, x,
                                                        *_grid(table))))
    j_table = j_acam.get_table(name, 8)
    ref = j_acam.eval_acam(j_table, jnp.asarray(x.numpy()),
                           jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()))
    np.testing.assert_array_equal(_bits(mine), _bits(ref))


@pytest.mark.parametrize("name", FUNCTIONS)
def test_compiled_search_bf16_inputs_upcast(name):
    """bf16 inputs upcast to float32, bitwise against the walk and
    ``repro`` on the upcast values (the kernels' wrappers upcast too)."""
    table, lo, hi = _thresholds(name, noisy=False)
    m = acam.table_map(table, "cpu")
    xb = (torch.from_numpy(np.random.default_rng(2).normal(size=4096) * 6)
          .to(torch.bfloat16))
    up = xb.to(torch.float32)
    mine = acam.eval_compiled(m, xb, *_grid(table))
    np.testing.assert_array_equal(_bits(mine), _bits(
        acam.eval_table(lo, hi, up, *_grid(table))))
    np.testing.assert_array_equal(_bits(mine), _bits(j_acam.eval_acam(
        j_acam.get_table(name, 8), jnp.asarray(up.numpy()))))


def test_compile_drops_nothing_that_matches():
    """Hand-made thresholds with repeats, an empty row (lo > hi), a NaN
    row, a point interval and infinite edges: the map equals the walk at
    and around every threshold, with and without ``unique``."""
    lo = torch.tensor([[0.0, 2.0, np.nan, -np.inf],
                       [1.0, 1.0, 5.0, 3.0]], dtype=torch.float32)
    hi = torch.tensor([[1.0, 2.0, 4.0, -3.0],
                       [1.0, 0.5, np.inf, 3.0]], dtype=torch.float32)
    for unique in (False, True):
        m = acam.compile_thresholds(lo, hi, unique=unique)
        x = _probe(m.breakpoints, n=2000)
        np.testing.assert_array_equal(
            _bits(acam.eval_compiled(m, x, -1.0, 0.25)),
            _bits(acam.eval_table(lo, hi, x, -1.0, 0.25)))


@pytest.mark.parametrize("name", FUNCTIONS)
def test_acam_apply_given_thresholds_matches_repro(name):
    """``acam_apply`` with caller-given (noisy) thresholds on the CPU (the
    plain version kernel D is held against on the card), bitwise against
    ``repro``'s ``eval_acam`` on the same thresholds; without them, the
    table's own."""
    from repro_torch.kernels.acam_activation.ops import acam_apply
    table, lo, hi = _thresholds(name, noisy=True, seed=3)
    x = torch.from_numpy((np.random.default_rng(4).normal(size=(64, 33))
                          * 4).astype(np.float32))
    j_table = j_acam.get_table(name, 8)
    np.testing.assert_array_equal(
        _bits(acam_apply(x, table, lo, hi)),
        _bits(j_acam.eval_acam(j_table, jnp.asarray(x.numpy()),
                               jnp.asarray(lo.numpy()),
                               jnp.asarray(hi.numpy()))))
    np.testing.assert_array_equal(
        _bits(acam_apply(x, table)),
        _bits(j_acam.eval_acam(j_table, jnp.asarray(x.numpy()))))
    with pytest.raises(ValueError):
        acam_apply(x, table, lo)


def test_table_map_is_cached_per_table_and_device():
    """The serve path's map is compiled once per (table, device): the
    second call returns the same object and runs no tensor op; other
    (noisy) thresholds compile afresh and differ from it."""
    table = acam.get_table("silu", 8)
    m = acam.table_map(table, "cpu")
    with _OpCount() as ops:
        again = acam.table_map(table, torch.device("cpu"))
    assert again is m and ops.n == 0
    clean = acam.compile_thresholds(*acam.table_thresholds(table, "cpu"),
                                    unique=True)
    assert torch.equal(clean.breakpoints, m.breakpoints)
    assert torch.equal(clean.codes, m.codes)
    _, lo, hi = _thresholds("silu", noisy=True, seed=5)
    noisy = acam.compile_thresholds(lo, hi)
    assert noisy is not m and not torch.equal(
        noisy.breakpoints[:m.breakpoints.shape[0]], m.breakpoints)
    x = _probe(noisy.breakpoints, n=1000)
    np.testing.assert_array_equal(
        _bits(acam.eval_compiled(noisy, x, *_grid(table))),
        _bits(acam.eval_table(lo, hi, x, *_grid(table))))


def test_per_call_compile_op_count():
    """Host cost of a per-call compile (``fused_crossbar_acam`` and
    ``acam_apply`` given thresholds): a fixed list of aten ops (47 with
    this PyTorch, views included) of fixed shapes — no data-dependent
    size, so no wait for the device on the card."""
    _, lo, hi = _thresholds("gelu", noisy=True)
    with _OpCount() as ops:
        m = acam.compile_thresholds(lo, hi)
    assert ops.n <= 50, ops.names
    assert not any("unique" in op or "nonzero" in op or "item" in op
                   for op in ops.names)
    assert m.breakpoints.shape == (2 * lo.numel(),)


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside the block."""

    def __enter__(self):
        self.n, self.names = 0, []
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))
