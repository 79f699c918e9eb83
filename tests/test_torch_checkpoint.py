"""The port's checkpointing (``checkpoint/manager.py``), its
fault-tolerant loop (``runtime/fault_tolerance.py``) and the train CLI's
restart, held against ``repro`` on the CPU.

The checkpoint and loop tests of ``tests/test_checkpoint_runtime.py`` on
the port's tensors (its two compression tests belong with the
multi-device work); a checkpoint written by either package restored by
the other, bit for bit, on ``repro``'s reduced ``minicpm_2b`` state
(float32 masters, AdamW moments and its int32 step); bfloat16 leaves
round-tripped bit for bit; and the train CLI killed at step 7 and resumed
from its step-5 checkpoint: on the CPU its losses and final parameters are
an uninterrupted run's bit for bit (eager CPU PyTorch repeats itself;
``repro``'s own test asks rtol 1e-4), with ``--naf`` too.
"""
import inspect
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as j_get_config
from repro.models import lm as j_lm
from repro.nn.module import param_dtype
from repro.optim import adamw as j_adamw

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import from_jax
from repro_torch.core.drift import flatten
from repro_torch.launch.train import run
from repro_torch.runtime.fault_tolerance import resilient_loop

torch.set_num_threads(1)


def test_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.tensor(7, dtype=torch.int32)}}
    m.save(tree, 5)
    out, step = m.restore_latest(tree)
    assert step == 5
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.int32 and int(out["b"]["c"]) == 7
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_5"]
    assert sorted(os.listdir(tmp_path / "step_5")) == ["arrays.npz",
                                                       "tree.json"]


def test_retention_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(2)}
    for s in (10, 20, 30):
        m.save(tree, s)
    assert m.available_steps() == [20, 30]
    assert m.latest_step() == 30


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=True)
    m.save({"x": torch.ones(128)}, 1, blocking=False)
    m.wait()
    assert m.latest_step() == 1


def test_async_save_snapshot_immune_to_in_place_update(tmp_path):
    """``save`` owns its bytes before it returns: the port's train step
    and ``adamw.update`` write in place, and ``.numpy()`` of a CPU tensor
    aliases it, so a ``mul_`` between ``save(blocking=False)`` and
    ``wait()`` must not reach the file (the port's form of ``repro``'s
    donated-update regression)."""
    m = CheckpointManager(str(tmp_path), async_write=True)
    x = torch.arange(1 << 16, dtype=torch.float32)
    original = x.clone()
    m.save({"x": x}, 1, blocking=False)
    x.mul_(-1.0)
    m.wait()
    out, step = m.restore_latest({"x": torch.zeros_like(x)})
    assert step == 1
    assert torch.equal(out["x"], original)


def test_async_save_failure_reraised_not_swallowed(tmp_path):
    """A failed async write is parked and re-raised by the next
    ``wait()``/``save()``/``close()``; the manager keeps working."""
    m = CheckpointManager(str(tmp_path), async_write=True)
    tree = {"x": torch.ones(8)}
    good = m.dir
    m.dir = str(tmp_path / "missing" / "nope")       # forces mkdtemp to fail
    m.save(tree, 1, blocking=False)
    with pytest.raises(RuntimeError, match="step 1 failed"):
        m.wait()
    m.dir = good                     # error cleared: manager still usable
    m.save(tree, 2, blocking=False)
    m.close()
    assert m.latest_step() == 2
    m.dir = str(tmp_path / "missing" / "nope")
    m.save(tree, 3, blocking=False)
    m._pending.join()                # deterministically park the error
    m.dir = good
    with pytest.raises(RuntimeError, match="step 3 failed"):
        m.save(tree, 4, blocking=False)
    m.save(tree, 5, blocking=False)  # cleared again
    m.close()
    assert m.latest_step() == 5


def test_async_save_close_joins_pending_writer(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=True)
    m.save({"x": torch.arange(4.0)}, 9, blocking=False)
    m.close()
    assert m._pending is None
    assert m.latest_step() == 9
    m.dir = str(tmp_path / "gone" / "dir")
    m.save({"x": torch.arange(4.0)}, 10, blocking=False)
    with pytest.raises(RuntimeError, match="step 10 failed"):
        m.close()
    m.close()                        # idempotent after the error drained


def test_resilient_loop_restarts_after_failure(tmp_path):
    m = CheckpointManager(str(tmp_path))
    calls = {"fails": 0}

    def fail_injector(step, restarts):
        if step == 7 and restarts == 0:
            calls["fails"] += 1
            raise RuntimeError("injected node failure")

    def step_fn(state, i):
        return {"acc": state["acc"] + i,
                "i": torch.tensor(i, dtype=torch.int32)}

    state = {"acc": torch.tensor(0.0), "i": torch.tensor(-1,
                                                         dtype=torch.int32)}
    final, report = resilient_loop(step_fn, state, steps=10, manager=m,
                                   ckpt_every=5, fail_injector=fail_injector)
    assert calls["fails"] == 1
    assert report.restarts == 1
    assert float(final["acc"]) == sum(range(10))   # no skipped/repeated data
    assert final["i"].dtype == torch.int32 and int(final["i"]) == 9


def test_resilient_loop_detects_stragglers():
    def step_fn(state, i):
        time.sleep(0.25 if i == 20 else 0.005)
        return state

    _, report = resilient_loop(step_fn, {}, steps=25, manager=None,
                               straggler_factor=5.0)
    assert any(e["step"] == 20 for e in report.straggler_events)


def test_resilient_loop_times_steps_with_perf_counter():
    src = inspect.getsource(resilient_loop)
    assert not re.search(r"=\s*time\.time\(\)", src)
    assert "perf_counter" in src


def test_resilient_loop_failure_before_first_checkpoint_reraises(tmp_path):
    """No checkpoint to roll back to: the failure surfaces and no step
    re-runs; after a checkpoint the same failure restores and completes."""
    m = CheckpointManager(str(tmp_path))
    seen = []

    def fail_injector(step, restarts):
        if step == 3 and restarts == 0:
            raise RuntimeError("node failure before first checkpoint")

    def step_fn(state, i):
        seen.append(i)
        return state

    with pytest.raises(RuntimeError, match="before first checkpoint"):
        resilient_loop(step_fn, {}, steps=10, manager=m, ckpt_every=5,
                       fail_injector=fail_injector)
    assert seen == [0, 1, 2]

    def fail_late(step, restarts):
        if step == 7 and restarts == 0:
            raise RuntimeError("late failure")

    def acc_fn(state, i):
        return {"acc": state["acc"] + i}

    final, report = resilient_loop(acc_fn, {"acc": torch.tensor(0.0)},
                                   steps=10, manager=m, ckpt_every=5,
                                   fail_injector=fail_late)
    assert report.restarts == 1
    assert float(final["acc"]) == sum(range(10))


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _j_state():
    """``repro``'s reduced ``minicpm_2b`` ``{"params", "opt"}``: float32
    masters and AdamW state, with moments and step made non-trivial."""
    cfg = j_get_config("minicpm_2b", reduced=True)
    with param_dtype(jnp.float32):
        params = j_lm.init_params(jax.random.key(0), cfg)
    opt = j_adamw.init(params)
    rng = np.random.default_rng(0)
    opt["m"] = jax.tree.map(lambda x: jnp.asarray(rng.normal(
        size=x.shape).astype(np.float32)), opt["m"])
    opt["v"] = jax.tree.map(lambda x: jnp.asarray(rng.random(
        x.shape).astype(np.float32)), opt["v"])
    opt["step"] = jnp.int32(3)
    return {"params": params, "opt": opt}


def _equal_trees(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


def test_repro_checkpoint_restores_in_port_bitwise(tmp_path):
    state = _j_state()
    JManager(str(tmp_path)).save(state, 7)
    want = from_jax(jax.tree.map(np.asarray, state), device="cpu")
    template = jax.tree.map(torch.zeros_like, want)
    got, step = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert step == 7
    assert got["opt"]["step"].dtype == torch.int32
    _equal_trees(got, want)


def test_port_checkpoint_restores_in_repro_bitwise(tmp_path):
    state = _j_state()
    mine = from_jax(jax.tree.map(np.asarray, state), device="cpu")
    CheckpointManager(str(tmp_path)).save(mine, 4)
    got, step = JManager(str(tmp_path)).restore_latest(state)
    assert step == 4
    for (path, x), y in zip(flatten(mine), jax.tree.leaves(got)):
        assert np.asarray(y).dtype == x.numpy().dtype, path
        assert np.array_equal(np.asarray(y), x.numpy()), path


def test_bfloat16_leaves_round_trip_bitwise(tmp_path):
    """bfloat16 leaves are stored as their 16-bit patterns (uint16) and
    restored bit for bit, NaN payloads and signed zeros included; a
    ``repro`` bfloat16 leaf (raw ``V2`` in its npz) restores too."""
    bits = torch.from_numpy(np.array(
        [0, 0x8000, 0x3F80, 0x7FC1, 0xFF80, 0x0001, 0x7F7F],
        np.uint16).view(np.int16))
    x = bits.view(torch.bfloat16)
    y = torch.randn(5, 3).to(torch.bfloat16)
    m = CheckpointManager(str(tmp_path / "port"))
    m.save({"x": x, "y": y}, 1)
    with np.load(tmp_path / "port" / "step_1" / "arrays.npz") as data:
        assert data["a0"].dtype == np.uint16
    out, _ = m.restore_latest({"x": torch.zeros_like(x),
                               "y": torch.zeros_like(y)})
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), bits)
    assert torch.equal(out["y"].view(torch.int16), y.view(torch.int16))
    jy = jnp.asarray(np.asarray(y.float())).astype(jnp.bfloat16)
    JManager(str(tmp_path / "ref")).save({"y": jy}, 2)
    got, _ = CheckpointManager(str(tmp_path / "ref")).restore_latest(
        {"y": torch.zeros_like(y)})
    assert torch.equal(got["y"].view(torch.int16), y.view(torch.int16))


# ---------------------------------------------------------------------------
# the train CLI's restart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("naf", [False, True], ids=["plain", "naf"])
def test_training_restart_bit_exact(tmp_path, capsys, naf):
    """Killed at step 7, restarted from the step-5 checkpoint: the
    resumed losses and the step-10 parameters and optimizer state equal an
    uninterrupted run's bit for bit on the CPU."""
    argv = ["--steps", "10", "--batch", "2", "--seq", "16", "--ckpt-every",
            "5", "--device", "cpu"] + (["--naf"] if naf else [])
    ck, clean_ck = str(tmp_path / "ck"), str(tmp_path / "clean")
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        run(argv + ["--ckpt-dir", ck, "--fail-at-step", "7"])
    assert CheckpointManager(ck).latest_step() == 5
    resumed = run(argv + ["--ckpt-dir", ck])
    assert "[train] restored checkpoint at step 5" in capsys.readouterr().out
    clean = run(argv + ["--ckpt-dir", clean_ck])
    assert len(resumed) == 5 and resumed == clean[5:]
    a, b = CheckpointManager(ck), CheckpointManager(clean_ck)
    assert a.latest_step() == b.latest_step() == 10
    with np.load(os.path.join(ck, "step_10", "arrays.npz")) as x, \
            np.load(os.path.join(clean_ck, "step_10", "arrays.npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        for name in x.files:
            assert np.array_equal(x[name], y[name]), name
