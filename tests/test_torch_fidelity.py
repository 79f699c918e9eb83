"""The port's closed-loop fidelity (``core/drift.py``, ``launch/fidelity.py``
and the paged engine's drift/fidelity plumbing) held against ``repro`` on
the CPU, at the reduced config of tests/engine_harness.py.

* **Drift model** — bitwise: the per-leaf ``split``/``fold_in`` keys in
  ``jax.tree.flatten`` order, ``stuck_hi``, ``g_prog`` under IDEAL noise,
  the sign channel and ``w_max``, chunked draws against whole-leaf draws,
  and the uniforms under ``exponential``.  With a stated tolerance:
  ``exponential`` and ``t_fault`` within ``EXP_ULPS`` (``log1p`` rounds an
  ulp apart between the frameworks; a fault mask may differ only where
  ``t`` is that close to ``t_fault``), ``g_prog`` with noise within
  ``normal``'s ``NORMAL_ULPS``, the read weights within ``READ_TOL``
  (``drift_factor``'s ``pow`` rounds an ulp apart and ``(g - g_min) /
  ratio`` cancels).  The scale-0 shortcut leaves the state unchanged.
* **FidelityMonitor** — the reference suite's ``observe`` sequences give
  equal actions, spec_k, EWMA and event logs.
* **Engines** — the ladder walks backoff -> reprogram -> disable (and
  reprogram -> escalate in the sawtooth) under the reference tests'
  settings, as ``repro``'s engine does; drift changes greedy tokens against
  non-spec serving only at a near-tie; a same-seed replay is bitwise,
  sampled requests included; drift without ``spec_k`` raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
from repro.core import drift as j_drift
from repro.core.noise import NoiseModel as JNoiseModel
from repro.launch import fidelity as j_fid
from repro.launch.spec_decode import quantize_draft_params as j_quantize

from repro_torch.convert import from_jax
from repro_torch.core import drift
from repro_torch.core.noise import IDEAL, NoiseModel
from repro_torch.launch import fidelity, prng
from repro_torch.launch.engine import PagedServeEngine
from test_torch_spec import (CFG, WQ, _params, audit, near_ties,
                             port_engine, run_port)

torch.set_num_threads(1)

EXP_ULPS = 2          # log1p: measured 1 ulp apart on 2^22 draws
NORMAL_ULPS = 4       # XLA's erf_inv polynomial (tests/test_torch_noise.py)
READ_TOL = 2.0 ** -20  # read weights: |diff| <= READ_TOL * w_max per leaf


def _key(seed: int):
    return (jax.random.key(seed),
            torch.from_numpy(np.asarray(jax.random.key_data(
                jax.random.key(seed))).astype(np.int64)))


def _qparams():
    """``repro``'s quantized drafter of the reduced model: numpy leaves, so
    both packages program the same float32 targets."""
    return jax.tree.map(np.asarray, j_quantize(H.shared_params()))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _leaves(tree, is_leaf=None):
    return [np.asarray(x) for x in jax.tree.leaves(tree, is_leaf=is_leaf)]


def _cells(state):
    """Per-leaf cell dicts of a port state, in flatten order, as numpy."""
    return [{k: np.asarray(v) for k, v in st.items()}
            for _, st in drift.flatten(state["cells"],
                                       is_leaf=drift._is_cell_state)]


def _j_cells(state):
    return [jax.tree.map(np.asarray, st)
            for st in jax.tree.leaves(state["cells"],
                                      is_leaf=j_drift._is_cell_state)]


def _port_state_from(j_state):
    """``repro``'s programmed state in the port's layout (int8 signs)."""
    def conv(x):
        if j_drift._is_cell_state(x):
            return {"g_prog": torch.from_numpy(np.array(x["g_prog"])),
                    "sign": torch.from_numpy(
                        np.array(x["sign"]).astype(np.int8)),
                    "w_max": torch.tensor(np.float32(x["w_max"])),
                    "t_fault": torch.from_numpy(np.array(x["t_fault"])),
                    "stuck_hi": torch.from_numpy(np.array(x["stuck_hi"]))}
        return {k: conv(v) for k, v in x.items()}
    return {"cells": conv(j_state["cells"]),
            "t_prog": float(j_state["t_prog"])}


# ---------------------------------------------------------------------------
# the drift model
# ---------------------------------------------------------------------------

def test_flatten_order_and_leaf_keys_match_jax():
    """The port walks a parameter tree in ``jax.tree.flatten`` order
    (sorted keys at every level), and its per-leaf keys equal
    ``repro``'s ``_leaf_keys`` bit for bit; so do ``fold_in`` keys."""
    jp = H.shared_params()
    mine = drift.flatten(from_jax(jp, device="cpu"))
    ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [p for p, _ in mine] == [tuple(k.key for k in p) for p, _ in ref]
    for (_, a), (_, b) in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jk, tk = _key(11)
    ref_keys = _leaves(jax.tree.map(jax.random.key_data,
                                    j_drift._leaf_keys(jk, jp)))
    got = drift._leaf_keys(tk, len(mine)).numpy()
    np.testing.assert_array_equal(got, np.stack(ref_keys).astype(np.int64))
    for d in (0, 7, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            prng.fold_in(tk, d).numpy(),
            np.asarray(jax.random.key_data(jax.random.fold_in(jk, d)))
            .astype(np.int64))


def test_exponential_matches_jax():
    """The uniforms under ``exponential`` are ``jax.random``'s bit for bit;
    ``-log1p(-u)`` is within ``EXP_ULPS``."""
    jk, tk = _key(7)
    shape = (64, 4099)
    u = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(), u)
    ref = np.asarray(jax.random.exponential(jk, shape, jnp.float32))
    mine = prng.exponential(tk, shape).numpy()
    assert _ulps(mine, ref).max() <= EXP_ULPS
    assert (mine >= 0).all() and np.isfinite(mine).all()


@pytest.mark.parametrize("fn", ["random_bits", "uniform", "normal",
                                "bernoulli", "exponential"])
def test_chunked_draws_equal_whole_draws(fn):
    """Counter offsets: a leaf's flattened index drawn in chunks equals the
    whole-shape draw bit for bit."""
    _, tk = _key(3)
    shape = (17, 301)
    draw = getattr(prng, fn)
    args = (0.3,) if fn == "bernoulli" else ()
    whole = draw(tk, *args, shape).reshape(-1)
    n = whole.numel()
    parts = torch.cat([draw(tk, *args, (min(1000, n - o),), offset=o)
                       for o in range(0, n, 1000)])
    assert torch.equal(whole, parts)


def test_drift_model_validates_and_factor_matches_repro():
    for bad in (dict(nu=-0.1), dict(t0=0.0), dict(fault_rate=-1.0),
                dict(verify_passes=0), dict(nu=float("nan"))):
        for mod in (drift, j_drift):
            with pytest.raises(ValueError):
                mod.DriftModel(**bad)
    rng = np.random.default_rng(0)
    for nu, t0 in ((0.1, 1.0), (2.0, 150.0), (0.5, 2.0)):
        mine, ref = drift.DriftModel(nu=nu, t0=t0), j_drift.DriftModel(
            nu=nu, t0=t0)
        dts = np.concatenate([[0.0, -3.0], rng.uniform(0, 1e4, 300)])
        want = np.asarray(jax.jit(jax.vmap(ref.drift_factor))(
            jnp.asarray(dts, jnp.float32)))
        got = np.array([mine.drift_factor(d) for d in dts], np.float32)
        assert _ulps(got, want).max() <= 1        # pow rounds an ulp apart
        assert got[0] == got[1] == 1.0


@pytest.mark.parametrize("fault_rate", [0.0, 0.05])
def test_program_params_matches_repro_bitwise_under_ideal_noise(fault_rate):
    """IDEAL noise (the drift default): ``g_prog``, ``stuck_hi``, the sign
    channel and ``w_max`` bitwise ``repro``'s; ``t_fault`` within
    ``EXP_ULPS`` and every fault mask the two disagree on lies within
    ``EXP_ULPS`` of ``t``."""
    q = _qparams()
    jk, tk = _key(5)
    jm = j_drift.DriftModel(nu=0.5, t0=2.0, fault_rate=fault_rate)
    m = drift.DriftModel(nu=0.5, t0=2.0, fault_rate=fault_rate)
    ref = _j_cells(j_drift.program_params(jk, q, jm, t=3.0))
    state = drift.program_params(tk, from_jax(q, device="cpu"), m, t=3.0)
    assert state["t_prog"] == 3.0
    flips = 0
    for mine, want in zip(_cells(state), ref):
        np.testing.assert_array_equal(mine["g_prog"], want["g_prog"])
        np.testing.assert_array_equal(mine["stuck_hi"], want["stuck_hi"])
        np.testing.assert_array_equal(mine["sign"], want["sign"])
        assert mine["w_max"] == want["w_max"]
        assert mine["sign"].dtype == np.int8
        if fault_rate == 0:
            assert np.isinf(mine["t_fault"]).all()
            continue
        assert _ulps(mine["t_fault"], want["t_fault"]).max() <= EXP_ULPS
        for t in (1.0, 10.0, 40.0):
            differ = (mine["t_fault"] <= t) != (want["t_fault"] <= t)
            flips += int(differ.sum())
            near = _ulps(want["t_fault"][differ],
                         np.full(differ.sum(), t, np.float32))
            assert (near <= EXP_ULPS).all()
    assert flips == 0                       # measured: none at these t
    assert drift.fault_fraction(state, 40.0) == pytest.approx(
        float(j_drift.fault_fraction(j_drift.program_params(jk, q, jm),
                                     40.0)), abs=1e-6)


def test_ideal_noise_shortcut_leaves_the_state_unchanged():
    """The scale-0 shortcut skips the programming normals: drawing them
    (``NoiseModel.program`` at scale 0) gives the same ``g_prog`` bit for
    bit, at ``verify_passes`` 1 and 3."""
    q = from_jax(_qparams(), device="cpu")
    _, tk = _key(9)
    for passes in (1, 3):
        m = drift.DriftModel(fault_rate=0.01, verify_passes=passes)
        state = drift.program_params(tk, q, m)
        _, pkey = prng.split(tk)
        pkeys = drift._leaf_keys(pkey, len(drift.flatten(q)))
        for (path, w), pk, cells in zip(drift.flatten(q), pkeys,
                                        _cells(state)):
            tg = drift._Targets(w, m, None)
            g_target, _ = tg.cells(0, w.numel())
            g = IDEAL.program(pk, g_target)
            for i in range(1, passes):
                cand = IDEAL.program(prng.fold_in(pk, i), g_target)
                g = torch.where(torch.abs(cand - g_target)
                                < torch.abs(g - g_target), cand, g)
            np.testing.assert_array_equal(g.numpy(),
                                          cells["g_prog"].reshape(-1))


def test_program_params_with_noise_matches_repro():
    """Programming noise (scale 1, three verify passes): ``g_prog`` within
    ``NORMAL_ULPS`` of ``repro``'s where both pick the same attempt; a
    different pick is allowed only where the two attempts' distances to
    the target are within that tolerance of each other (counted)."""
    q = _qparams()
    jk, tk = _key(13)
    jm = j_drift.DriftModel(noise=JNoiseModel(), verify_passes=3)
    m = drift.DriftModel(noise=NoiseModel(), verify_passes=3)
    ref = _j_cells(j_drift.program_params(jk, q, jm))
    mine = _cells(drift.program_params(tk, from_jax(q, device="cpu"), m))
    far = 0
    for a, b in zip(mine, ref):
        u = _ulps(a["g_prog"], b["g_prog"])
        far += int((u > NORMAL_ULPS).sum())
        np.testing.assert_array_equal(a["stuck_hi"], b["stuck_hi"])
    assert far == 0


def test_chunked_program_and_read_equal_whole_leaf(monkeypatch):
    """Every pass walks a leaf in ``CHUNK``-element chunks: a chunk of 333
    elements (chunks straddle rows and leaves end mid-chunk) gives the
    whole-leaf state and read weights bit for bit, with noise and faults."""
    q = from_jax(_qparams(), device="cpu")
    _, tk = _key(17)
    m = drift.DriftModel(nu=0.3, fault_rate=0.02, noise=NoiseModel(),
                         verify_passes=2)
    out = []
    for chunk in (1 << 24, 333):
        monkeypatch.setattr(drift, "CHUNK", chunk)
        state = drift.program_params(tk, q, m)
        drift.reprogram_params(prng.fold_in(tk, 1), state, q, m, 4.0)
        w = drift.read_params(state, m, 9.0, read_key=prng.fold_in(tk, 2))
        out.append((_cells(state), [x.numpy() for _, x in drift.flatten(w)]))
    for a, b in zip(out[0][0], out[1][0]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("read_noise", [False, True])
def test_read_params_matches_repro(read_noise):
    """``repro``'s programmed state (drift, faults, stuck-high cells on
    zero weights) read by both at several virtual times: the port's
    weights within ``READ_TOL * w_max`` of ``jax.jit(read_params)``'s, per
    leaf; writing into a bf16/f32 serving tree (``out=``) gives the float32
    result cast."""
    q = _qparams()
    jk, tk = _key(19)
    noise = JNoiseModel() if read_noise else None
    jm = j_drift.DriftModel(nu=0.7, t0=3.0, fault_rate=0.03,
                            **({"noise": noise} if noise else {}))
    m = drift.DriftModel(nu=0.7, t0=3.0, fault_rate=0.03,
                         **({"noise": NoiseModel()} if noise else {}))
    j_state = j_drift.program_params(jk, q, jm, t=1.0)
    state = _port_state_from(j_state)
    if read_noise:
        read = jax.jit(lambda st, t, k: j_drift.read_params(st, jm, t,
                                                            read_key=k))
    else:
        read = jax.jit(lambda st, t: j_drift.read_params(st, jm, t))
    zero_hi = 0
    for t in (1.0, 2.5, 20.0, 60.0):
        rk = jax.random.fold_in(jax.random.key(4), int(t))
        want = _leaves(read(j_state, jnp.float32(t), rk) if read_noise
                       else read(j_state, jnp.float32(t)))
        trk = (torch.from_numpy(np.asarray(jax.random.key_data(rk))
                                .astype(np.int64)) if read_noise else None)
        got = drift.read_params(state, m, t, trk)
        for (_, g), w, cells in zip(drift.flatten(got), want,
                                    _cells(state)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=READ_TOL * float(cells["w_max"]))
            hi = ((cells["t_fault"] <= t) & cells["stuck_hi"]
                  & (cells["sign"] == 0))
            zero_hi += int(hi.sum())
            assert (g.numpy()[hi] > 0).all()
        serving = {k: v for k, v in jax.tree.map(
            lambda x: torch.empty(x.shape, dtype=torch.bfloat16), q).items()}
        drift.read_params(state, m, t, trk, out=serving)
        for (_, s), (_, g) in zip(drift.flatten(serving),
                                  drift.flatten(got)):
            assert torch.equal(s, g.to(torch.bfloat16))
    assert zero_hi > 0


def test_reprogram_keeps_faults_and_resets_the_clock():
    """``reprogram_params`` rewrites the cells in place at ``t`` and keeps
    the fault record; under IDEAL noise the programmed conductances equal
    ``repro``'s reprogrammed ones."""
    q = _qparams()
    jk, tk = _key(23)
    jm, m = (j_drift.DriftModel(fault_rate=0.02),
             drift.DriftModel(fault_rate=0.02))
    j_state = j_drift.reprogram_params(jax.random.fold_in(jk, 1),
                                       j_drift.program_params(jk, q, jm),
                                       q, jm, jnp.float32(7.5))
    state = drift.program_params(tk, from_jax(q, device="cpu"), m)
    before = [c["t_fault"].copy() for c in _cells(state)]
    out = drift.reprogram_params(prng.fold_in(tk, 1), state,
                                 from_jax(q, device="cpu"), m, 7.5)
    assert out is state and state["t_prog"] == 7.5
    for mine, want, tf in zip(_cells(state), _j_cells(j_state), before):
        np.testing.assert_array_equal(mine["g_prog"], want["g_prog"])
        np.testing.assert_array_equal(mine["t_fault"], tf)


# ---------------------------------------------------------------------------
# FidelityMonitor / policy / injection against repro's
# ---------------------------------------------------------------------------

def _feed_both(policy_kw, spec_k, feeds):
    """Drive the port's and ``repro``'s monitors with the same
    ``(acc, ticks, t0, dt, k)`` feeds (the reference suite's ``feed``);
    return both histories."""
    out = []
    for mod in (fidelity, j_fid):
        mon = mod.FidelityMonitor(mod.FidelityPolicy(**policy_kw), spec_k)
        hist, tick = [], 0
        for acc, ticks, t0, dt, k in feeds:
            for i in range(ticks):
                a = mon.observe(drafted=k, accepted=round(k * acc),
                                t=t0 + (i + 1) * dt, tick=tick)
                tick += 1
                hist.append((a, mon.spec_k, mon.ewma, mon.disabled))
        out.append((hist, list(mon.events), mon.events.dropped))
    return out


@pytest.mark.parametrize("policy_kw,spec_k,feeds", [
    (dict(window=2), 4, [(0.4, 2, 0, 1, 10)] * 3),
    (dict(window=2, reprogram_patience=0), 4,
     [(0.1, 2, 0, 1, 10), (0.9, 2, 0, 1, 10)]),
    (dict(window=1), 4, [(0.4, 1, 0, 1, 10)] * 2 + [(1.0, 3, 0, 1, 10)]),
    (dict(window=1, reprogram_patience=0, max_reprograms=2), 2,
     [(0.0, 3, 0, 1, 10), (0.0, 10, 0, 1, 10)]),
    (dict(window=1, reprogram_patience=2, max_reprograms=5), 2,
     [(0.0, 4, 0, 1, 10)]),
    (dict(window=1, reprogram_patience=0, max_reprograms=1,
          probe_interval_s=10.0), 4,
     [(0.0, 2, 0, 1, 10), (0.0, 12, 2, 1, 10)]),
    (dict(window=1, reprogram_patience=0, max_reprograms=1,
          probe_interval_s=5.0), 4,
     [(0.0, 2, 0, 1, 10), (1.0, 10, 2, 1, 10)]),
    (dict(window=2), 2, [(0.0, 10, 0, 1, 0)]),
    (dict(window=1, event_log_cap=3, max_reprograms=50,
          reprogram_patience=0), 4, [(0.2, 12, 0, 1, 10)]),
    (dict(window=3, ewma_alpha=0.5, soft_threshold=0.65,
          hard_threshold=0.45, recover_threshold=0.7), 4,
     [(0.7, 6, 0, 5, 8), (0.5, 6, 30, 5, 8), (0.25, 9, 60, 5, 8),
      (0.875, 9, 105, 5, 8)]),
], ids=["backoff", "reprogram-recover", "escalate", "disable", "grace",
        "probe-fails", "probe-recovers", "idle", "log-cap", "mixed"])
def test_monitor_sequences_match_repro(policy_kw, spec_k, feeds):
    mine, ref = _feed_both(policy_kw, spec_k, feeds)
    assert mine == ref
    assert any(a for a, *_ in mine[0]) or policy_kw == dict(window=2)


@pytest.mark.parametrize("bad", [dict(window=0), dict(ewma_alpha=0.0),
                                 dict(ewma_alpha=1.5),
                                 dict(soft_threshold=0.2,
                                      hard_threshold=0.4),
                                 dict(recover_threshold=0.4),
                                 dict(min_spec_k=0), dict(max_reprograms=0),
                                 dict(probe_interval_s=-1.0),
                                 dict(event_log_cap=0)])
def test_policy_rejects_bad_config_like_repro(bad):
    for mod in (fidelity, j_fid):
        with pytest.raises(ValueError):
            mod.FidelityPolicy(**bad)


def test_injection_validates_and_tick_seconds_match_repro():
    for bad in (dict(dt_step=0.0), dict(dt_step=-1.0),
                dict(draft_cost=-0.1), dict(reprogram_s=float("nan"))):
        for mod in (fidelity, j_fid):
            with pytest.raises(ValueError):
                mod.DriftInjection(**bad)
    mine = fidelity.DriftInjection(dt_step=3.0, draft_cost=0.5)
    ref = j_fid.DriftInjection(dt_step=3.0, draft_cost=0.5)
    for k in (0, 1, 4):
        assert mine.tick_seconds(k, 8) == ref.tick_seconds(k, 8)
    with pytest.raises(ValueError):
        fidelity.FidelityMonitor(fidelity.FidelityPolicy(), 0)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def steady_trace(n, gen=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(tuple(int(x) for x in rng.integers(0, 3, 5)), gen, 0)
            for _ in range(n)]


SAWTOOTH = dict(spec_k=2, nu=2.0, t0=150.0, fault_rate=0.0, dt_step=5.0,
                reprogram_s=20.0,
                fidelity=dict(window=4, soft_threshold=0.5,
                              hard_threshold=0.3, recover_threshold=0.6,
                              reprogram_patience=1))
DISABLE = dict(spec_k=2, nu=0.5, t0=2.0, fault_rate=0.05, dt_step=10.0,
               reprogram_s=0.0,
               fidelity=dict(window=3, reprogram_patience=1,
                             max_reprograms=2))


def drift_engine(spec_k, nu, t0, fault_rate, dt_step, reprogram_s, fidelity,
                 seed=3, **over) -> PagedServeEngine:
    """A fresh drift engine with the harness's settings (the port's twin of
    ``engine_harness.drift_engine``)."""
    from repro_torch.launch.fidelity import DriftInjection, FidelityPolicy
    inj = DriftInjection(model=drift.DriftModel(nu=nu, t0=t0,
                                                fault_rate=fault_rate),
                         seed=seed, dt_step=dt_step, reprogram_s=reprogram_s)
    kw = H.engine_kwargs(page_size=H.PAGE, num_pages=H.NUM_PAGES, **over)
    return PagedServeEngine(CFG, _params(), spec_k=spec_k, spec_draft=WQ,
                            drift=inj, fidelity=FidelityPolicy(**fidelity),
                            device="cpu", **kw)


def _events(stats):
    return [(e["event"], e["spec_k"], e["ewma"], e["t"], e["tick"])
            for e in stats["events"]]


def test_ladder_walks_backoff_reprogram_disable_like_repro():
    """Dense stuck-at faults (the reference suite's disable setting):
    acceptance collapses, the ladder backs off, reprograms twice (stuck
    cells survive it) and disables the drafter; the engine goes on with
    the exact decode tick.  The ladder, clock, fault census and counters
    equal ``repro``'s engine's; tokens equal the non-spec engine's up to a
    near-tie; no page leaks."""
    trace = steady_trace(30)
    mine = drift_engine(**DISABLE)
    got = run_port(mine, trace)
    jkw = {k: v for k, v in DISABLE.items() if k != "fidelity"}
    ref = H.drift_engine(**jkw, fidelity=j_fid.FidelityPolicy(
        **DISABLE["fidelity"]))
    want = H.run_trace(ref, trace)
    assert {r: t for r, (t, _) in got.items()} == want
    fs, jfs = mine.fidelity_stats, ref.fidelity_stats
    kinds = [e["event"] for e in fs["events"]]
    assert kinds[:2] == ["backoff", "reprogram"] and kinds[-1] == "disable"
    assert _events(fs) == _events(jfs)
    for key in ("vclock_s", "spec_k_live", "reprograms", "downtime_s",
                "disabled_ticks", "ewma", "disabled", "fault_fraction"):
        assert fs[key] == jfs[key], key
    assert fs["fault_fraction"] > 0.5 and fs["disabled_ticks"] > 0
    st, jst = mine.spec_stats, ref.spec_stats
    assert (st["drafted"], st["accepted"]) == (jst["drafted"],
                                               jst["accepted"])
    assert near_ties(trace, got, run_port(port_engine(), trace)) <= 1
    audit(mine)


def test_reprogram_recovers_acceptance_sawtooth():
    """Drift alone (the reference suite's sawtooth setting): acceptance
    falls (backoff), the hard threshold triggers a reprogram, the
    rewritten device recovers (escalate) and drifts again, with the
    downtime metered.  A reprogram may also be followed by another where
    the EWMA stays under the hard threshold: ``repro``'s engine does the
    same on this trace (its ladder: backoff, reprogram, escalate, backoff,
    reprogram, reprogram), so only the first recovery is asserted."""
    eng = drift_engine(**SAWTOOTH)
    trace = steady_trace(40)
    got = run_port(eng, trace)
    fs = eng.fidelity_stats
    kinds = [e["event"] for e in fs["events"]]
    assert fs["reprograms"] >= 2 and kinds.count("reprogram") >= 2
    first = kinds.index("reprogram")
    assert "backoff" in kinds[:first]
    assert "escalate" in kinds[first + 1:]
    assert fs["downtime_s"] == pytest.approx(20.0 * fs["reprograms"])
    assert fs["vclock_s"] > fs["downtime_s"]
    assert len(eng.reprogram_seconds) == fs["reprograms"]
    assert eng.drift_reads == eng.spec_stats["spec_steps"]
    assert near_ties(trace, got, run_port(port_engine(), trace)) <= 1
    audit(eng)


def test_heavy_drift_and_faults_change_tokens_only_at_near_ties():
    """Heavy drift, stuck-at accumulation and the full ladder (the
    reference suite's injection setting) on steady and COW/eviction
    traffic: greedy tokens equal the uninjected non-spec engine's up to a
    near-tie, and ``fidelity_stats`` sees the clock and the faults."""
    trace = steady_trace(24) + H.shared_prefix_cow_trace()
    eng = drift_engine(spec_k=2, nu=1.0, t0=20.0, fault_rate=2e-3,
                       dt_step=10.0, reprogram_s=50.0,
                       fidelity=dict(window=3, reprogram_patience=1,
                                     max_reprograms=2))
    got = run_port(eng, trace)
    assert near_ties(trace, got, run_port(port_engine(), trace)) <= 1
    fs = eng.fidelity_stats
    assert fs["vclock_s"] > 0 and fs["fault_fraction"] > 0
    assert eng.spec_stats["drafted"] > 0
    audit(eng)


def test_same_seed_replay_is_bitwise_including_sampled():
    """Two fresh engines with the same seeds serve a mixed greedy/sampled
    trace to identical tokens, fidelity logs and counters: the virtual
    clock keeps wall time out of every decision."""
    trace = H.random_mixed_trace(np.random.default_rng(11))
    outs, fstats, sstats = [], [], []
    for _ in range(2):
        eng = drift_engine(**SAWTOOTH)
        outs.append(run_port(eng, trace))
        fstats.append(eng.fidelity_stats)
        s = eng.spec_stats
        s.pop("draft_seconds")
        sstats.append(s)
    assert outs[0] == outs[1]
    assert fstats[0] == fstats[1] and sstats[0] == sstats[1]
    assert sstats[0]["drafted"] > 0


def test_undrifted_plant_serves_the_plain_spec_tokens():
    """nu = 0, no faults, IDEAL noise: the read-back drafter is the
    log-grid drafter up to the conductance map's rounding, so the tokens
    are the plain spec engine's; the telemetry trace carries the ladder's
    events as the monitor logs them."""
    trace = H.shared_prefix_cow_trace()
    inert = drift_engine(spec_k=2, nu=0.0, t0=1.0, fault_rate=0.0,
                         dt_step=1.0, reprogram_s=0.0, fidelity={},
                         telemetry=True)
    got = run_port(inert, trace)
    assert got == run_port(port_engine(2), trace)
    fs = inert.fidelity_stats
    assert fs["fault_fraction"] == 0.0 and fs["vclock_s"] > 0
    ladder = [e for e in inert.telemetry.trace if e["ev"] == "fidelity"]
    assert [e["kind"] for e in ladder] == [e["event"] for e in fs["events"]]
    assert inert.metrics.snapshot()["fidelity"] == fs


def test_drift_requires_spec_and_ladder_depths_are_cached():
    with pytest.raises(ValueError, match="spec_k"):
        drift_engine(spec_k=0, **{k: v for k, v in DISABLE.items()
                                  if k != "spec_k"})
    with pytest.raises(ValueError, match="spec_k"):
        PagedServeEngine(CFG, _params(), max_slots=1,
                         max_len=8, fidelity=fidelity.FidelityPolicy(),
                         device="cpu")
    eng = drift_engine(**DISABLE)
    assert eng._spec_fns_for(2) == (eng._draft_fn, eng._verify_fn)
    pair = eng._spec_fns_for(1)
    assert eng._spec_fns_for(1) is pair
