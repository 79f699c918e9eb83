#!/usr/bin/env python3
"""Acceptance of the full-width analog drafter against its drift factor.

    python3 tools/drift_acceptance_curve.py

Programs the weights-only drafter of full-width Qwen2.5-3B (seeded random
float32 weights, ``chip_smoke.py``'s seed) onto crossbar cells through
``PagedServeEngine(spec_k=4, drift=...)`` with ``nu = 1`` and ``t0 = 1``,
so the drift factor is ``1 / (1 + vclock)``, and a fidelity policy whose
window never closes (no ladder action).  For each factor it sets the
engine's virtual clock, serves 8 requests of ``chip_smoke.py``'s paged
trace (256 shared + 64-448 random prompt tokens, 16 new tokens, all
arriving at once) and prints the acceptance over that serve, with the
read time per tick.  Also prints the programming and one reprogramming
pass's seconds, the cell state's bytes and the peak device memory.  This
is the curve ``chip_smoke.py``'s ``DRIFT_T0`` is set from.  Needs one CUDA
GPU with about 60 GB free.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FACTORS = (1.0, 0.995, 0.99, 0.98, 0.97, 0.95, 0.93, 0.9, 0.85, 0.8, 0.7,
           0.5)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("drift_acceptance_curve: needs a CUDA GPU")
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.core.drift import DriftModel, state_bytes
    from repro_torch.core.engine import OFF, NLDPEConfig
    from repro_torch.kernels import build
    from repro_torch.launch.engine import PagedServeEngine
    from repro_torch.launch.fidelity import DriftInjection, FidelityPolicy
    from repro_torch.models import lm
    build.build_all()
    cfg = get_config("qwen2_5_3b")
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(smoke.SEED), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    eng = PagedServeEngine(
        cfg, params, max_slots=8, max_len=1024, nldpe=OFF, page_size=16,
        prefill_chunk=64, decode_block=4, spec_k=4,
        spec_draft=NLDPEConfig(enabled=False),
        drift=DriftInjection(DriftModel(nu=1.0, t0=1.0), seed=smoke.SEED,
                             dt_step=1e-9),
        fidelity=FidelityPolicy(window=10 ** 6))
    print(json.dumps({"program_s": eng.drift_program_seconds,
                      "state_bytes": state_bytes(eng._drift_state),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    base = smoke.make_trace(cfg, 8, 16, 0)
    curve = {}
    for j, f in enumerate(("warm-up",) + FACTORS):
        eng.vclock = 0.0 if f == "warm-up" else 1.0 / f - 1.0
        reqs = [dataclasses.replace(r, rid=100 * (j + 1) + r.rid,
                                    arrival=eng.tick) for r in base]
        eng.reset_window()
        reads, read_s = eng.drift_reads, eng.drift_read_seconds
        t0 = time.perf_counter()
        eng.run(reqs)
        w = eng.spec_stats["window"]
        row = {"factor": f, "acceptance": w["acceptance_rate"],
               "accepted": w["accepted"], "drafted": w["drafted"],
               "ticks": w["ticks"], "wall_s": time.perf_counter() - t0,
               "read_ms_per_tick": (eng.drift_read_seconds - read_s) * 1e3
               / max(eng.drift_reads - reads, 1)}
        print(json.dumps(row), flush=True)
        if f != "warm-up":
            curve[f] = w["acceptance_rate"]
    t0 = time.perf_counter()
    eng._execute_reprogram()
    print(json.dumps({"reprogram_s": time.perf_counter() - t0,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "curve": curve}))


if __name__ == "__main__":
    main()
