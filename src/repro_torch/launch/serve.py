"""Lockstep serving steps and the serve CLI of the port (port of
``repro.launch.serve``).

``build_prefill_step``/``build_decode_step`` are the whole-prompt prefill
and the one-token decode of a fixed batch over a lockstep cache;
``build_generate_fn`` is the greedy generation of ``gen_len`` tokens that
``repro`` runs as one ``lax.scan`` (a plain loop here, with no host sync
until the tokens are read), and ``python_loop_decode`` the per-token
baseline that reads each token back to the host.  Both give the same
tokens.

    python -m repro_torch.launch.serve [--nldpe | --fused] [--python-loop]
    python -m repro_torch.launch.serve --continuous [--nldpe | --fused]
    python -m repro_torch.launch.serve --paged [--nldpe | --fused]
                                       [--kv-quant {log8,int8}]
                                       [--host-cache-pages N]
                                       [--priority K]
                                       [--spec K [--spec-full-analog]
                                        [--drift NU] [--fault-rate R]
                                        [--drift-dt S]]
    ... --continuous | --paged [--telemetry] [--trace-out PATH]
                               [--profile-ticks N [--profile-dir DIR]]
                               [--metrics] [--async-serve]
                               [--mesh DP,TP [--mesh-rules NAME]]

The default branch prefills ``--batch`` prompts of ``--prompt-len`` tokens
and decodes ``--gen-len`` steps in lockstep; ``--continuous`` serves a
staggered trace through the slotted ``ServeEngine``, ``--paged`` a
shared-system-prompt trace through ``PagedServeEngine`` (``--kv-quant``
stores its pages as 8-bit codes; ``--spec K`` adds analog-draft
speculative decoding with K drafts per verify; ``--drift``/``--fault-rate``
age its drafter on a virtual clock under the fidelity ladder;
``--host-cache-pages N`` spills evicted radix pages to host memory and
restores them on a hit; ``--priority K`` gives every Kth request priority
1, which may preempt a running slot to host memory).  The engine demos
take ``--async-serve`` (the dispatch/drain pipeline of
``launch/async_engine.py`` over bucketed prefill), ``--mesh DP,TP``
(serve on a ("data", "model") mesh of DP * TP ranks under the
``--mesh-rules`` table, default ``serve_exact``: the CLI spawns its ranks
unless it already runs under ``torchrun``, and rank 0 prints the same
per-request tokens as the command without ``--mesh``; under ``serve``,
whose partial sums add in another order, up to near-ties; backends in
``launch/mesh.py``), ``--telemetry`` (latency percentiles and phase walls; the event
trace as JSONL with ``--trace-out``, a ``torch.profiler`` trace of the
first N ticks with ``--profile-ticks``) and ``--metrics`` (the registry
as Prometheus text).  A config whose ``kv_cache_dtype`` names
a grid gives every path quantized caches.  The model is the
reduced config of ``--arch`` (as the JAX CLI runs it) with seeded random
weights, on the GPU unless ``--device cpu``: ``qwen2_5_3b`` (default),
``qwen2_7b``, ``minicpm_2b``, ``gemma3_27b`` (sliding-window rings; every
path but ``--paged``), ``qwen3_moe_30b_a3b`` or ``llama4_scout_17b_a16e``
(MoE; every path, the engines printing the assignments dropped for
capacity), ``paligemma_3b`` or ``musicgen_large`` (every path, text-only
token prompts as in ``repro``'s CLI; the image prefix is
``build_prefill_step``'s ``patch_embeds``), ``recurrentgemma_9b``
(RG-LRU) or ``rwkv6_3b`` (RWKV6; these two on the lockstep path only, as
in ``repro``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.drift import DriftModel
from ..core.engine import NLDPEConfig, OFF
from ..models import lm
from ..obs import Telemetry
from ..parallel import sharding
from . import mesh as mesh_lib
from .engine import PagedServeEngine, Request, ServeEngine
from .fidelity import DriftInjection, FidelityPolicy


def build_prefill_step(cfg, *, nldpe: NLDPEConfig = OFF):
    """prefill(params, cache, tokens, patch_embeds=None) -> (last logits
    (B, V), cache): the whole prompt (B, S) at positions 0..S-1 — behind
    ``patch_embeds`` (B, P, d), an image prefix, at positions 0..P+S-1 —
    filling the lockstep ``cache`` in place; decoding then starts at
    position P + S."""
    def prefill(params, cache, tokens, patch_embeds=None):
        logits = lm.forward(params, tokens, cfg, mode="prefill", cache=cache,
                            nldpe=nldpe, patch_embeds=patch_embeds)
        return logits[:, -1], cache

    return prefill


def build_decode_step(cfg, *, nldpe: NLDPEConfig = OFF):
    """decode(params, cache, token (B,), pos) -> (logits (B, V), cache)."""
    def decode(params, cache, token, pos):
        return lm.decode_step(params, cfg, token, pos, cache,
                              nldpe=nldpe), cache
    return decode


def cache_capacity(cache: dict) -> int:
    """The longest position track of a model cache (== max_len whenever
    the model has a full-length attention layer)."""
    return max((t.shape[-1] for t in lm.position_tracks(cache)), default=0)


def build_generate_fn(cfg, gen_len: int, *, nldpe: NLDPEConfig = OFF):
    """Greedy decode of ``gen_len`` tokens (the first is ``tok0``).

    generate(params, cache, tok0, start_pos) -> (tokens (B, gen_len),
    cache).  Overflow guard: generating past the cache capacity would wrap
    the ring of every non-windowed layer and attend to overwritten
    positions, so when the pattern has an ``attn``, ``global`` or ``moe``
    layer the call checks ``start_pos + gen_len - 1`` against the cache's
    capacity and raises instead.  Purely windowed (and recurrent) stacks
    wrap their rings by design and are exempt, as in ``repro``.
    """
    wraps_garbage = any(t in ("attn", "global", "moe")
                        for t in cfg.layer_pattern)

    def generate(params, cache, tok0, start_pos):
        limit = cache_capacity(cache)
        sp = int(start_pos)
        if wraps_garbage and sp + gen_len - 1 > limit:
            raise ValueError(
                f"generate overflows the KV cache: start_pos={sp} + "
                f"gen_len={gen_len} needs {sp + gen_len - 1} positions but "
                f"the cache holds {limit}; non-windowed layers would wrap "
                f"their ring buffers and silently produce garbage. "
                f"Grow max_len or shrink gen_len.")
        tok, out = tok0, [tok0]
        for i in range(gen_len - 1):
            logits = lm.decode_step(params, cfg, tok, sp + i, cache,
                                    nldpe=nldpe)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1), cache

    return generate


def python_loop_decode(decode_fn, params, cache, tok0, start_pos: int,
                       gen_len: int):
    """The per-token baseline: one ``decode_fn`` call per token, each token
    read back to the host before the next step."""
    tok = tok0
    rows = [[int(t)] for t in tok0.cpu()]
    for i in range(gen_len - 1):
        logits, cache = decode_fn(params, cache, tok, start_pos + i)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        for row, t in zip(rows, nxt.cpu().tolist()):
            row.append(int(t))
        tok = nxt
    return torch.tensor(rows, dtype=torch.int32), cache


def _validate_args(p: argparse.ArgumentParser, args) -> None:
    """Fail fast on incoherent flag combinations (``repro``'s rules, for
    the flags the port has)."""
    engine = args.continuous or args.paged

    def moved(name):
        return getattr(args, name) != p.get_default(name)

    if args.continuous and args.paged:
        p.error("--continuous and --paged are mutually exclusive "
                "(pick one engine demo)")
    bad = [n for n in ("page_size", "host_cache_pages", "priority",
                       "num_pages", "system_prompt_len", "spec",
                       "spec_full_analog", "drift", "fault_rate",
                       "drift_dt", "kv_quant") if moved(n)]
    if bad and not args.paged:
        p.error(f"--{bad[0].replace('_', '-')} requires --paged "
                f"(the lockstep/--continuous paths ignore it)")
    bad = [n for n in ("slots", "requests", "mesh", "mesh_rules",
                       "telemetry", "trace_out", "profile_ticks", "metrics",
                       "async_serve")
           if moved(n)]
    if bad and not engine:
        p.error(f"--{bad[0].replace('_', '-')} requires an engine demo "
                f"(--continuous or --paged); the lockstep path ignores it")
    if moved("mesh_rules") and not args.mesh:
        p.error("--mesh-rules requires --mesh DP,TP")
    if args.mesh and (args.async_serve or args.drift is not None
                      or args.fault_rate):
        p.error("--mesh serves the tick loop without drift injection; the "
                "async pipeline and the drifting drafter under a mesh are "
                "not ported yet (ROADMAP.md A.2 queue, item 4)")
    if moved("profile_dir") and not args.profile_ticks:
        p.error("--profile-dir requires --profile-ticks N")
    if (args.drift is not None or args.fault_rate) and not args.spec:
        p.error("--drift/--fault-rate need --spec K (they age the "
                "analog draft path)")
    if args.python_loop and engine:
        p.error("--python-loop is a lockstep-path baseline; the engine "
                "demos always use the batched decode")
    if moved("batch") and engine:
        p.error("--batch sizes the lockstep path; engine demos size by "
                "--slots/--requests")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="qwen2_5_3b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-len", type=int, default=32)
    p.add_argument("--nldpe", action="store_true",
                   help="NL-DPE numerics (ACAM activations, log-domain "
                        "DMMul and softmax)")
    p.add_argument("--fused", action="store_true",
                   help="NL-DPE numerics with the fused crossbar->ACAM "
                        "kernel on every MLP gate and the log-domain "
                        "flash kernel in whole-prompt prefill")
    p.add_argument("--python-loop", action="store_true",
                   help="per-token decode loop reading each token back "
                        "(baseline; default is the generate fn)")
    p.add_argument("--continuous", action="store_true",
                   help="slotted continuous-batching engine over a mixed "
                        "trace (staggered arrivals)")
    p.add_argument("--paged", action="store_true",
                   help="paged engine with radix prefix sharing over a "
                        "shared-system-prompt trace")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--host-cache-pages", type=int, default=0,
                   help="host-memory spill tier for --paged (DESIGN.md "
                        "§13): LRU-evicted radix pages go to the host "
                        "instead of being destroyed, and radix hits "
                        "restore them; 0 disables")
    p.add_argument("--priority", type=int, default=0, metavar="K",
                   help="for --paged: give every Kth demo request "
                        "priority 1 (0 disables); higher priority admits "
                        "first and may preempt a running lower-priority "
                        "slot to host memory, which resumes later with "
                        "the same tokens")
    p.add_argument("--num-pages", type=int, default=None)
    p.add_argument("--system-prompt-len", type=int, default=24)
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative decode for --paged: K analog drafts "
                        "(NL-DPE log-quant numerics) per exact batched "
                        "verify pass (0 = off)")
    p.add_argument("--spec-full-analog", action="store_true",
                   help="draft with the full analog numerics (ACAM "
                        "activations, log-domain DMMul and softmax) instead "
                        "of the log-grid weights only; slower to simulate, "
                        "the same greedy tokens")
    p.add_argument("--kv-quant", choices=("log8", "int8"), default=None,
                   help="store KV pages as 8-bit codes + per-(page, head, "
                        "position) scales for --paged: 'log8' = the "
                        "drafter's sign-magnitude log grid (DESIGN.md "
                        "§11), 'int8' = uniform absmax grid")
    p.add_argument("--drift", type=float, default=None, metavar="NU",
                   help="with --paged --spec: age the analog drafter live "
                        "— power-law conductance drift exponent nu on a "
                        "virtual clock, with the acceptance-driven "
                        "backoff/reprogram/disable ladder closed around it "
                        "(DESIGN.md §10); only throughput moves")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   metavar="RATE",
                   help="per-cell stuck-at-fault Poisson arrival rate "
                        "(1/virtual-second) for --drift; faults survive "
                        "reprogramming")
    p.add_argument("--drift-dt", type=float, default=60.0, metavar="S",
                   help="virtual seconds per decode position for --drift "
                        "(accelerated aging clock; default 60)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--mesh", type=_mesh_shape, default=None,
                   metavar="DP,TP",
                   help="serve --continuous/--paged on a (data, model) "
                        "mesh of DP*TP ranks, e.g. 2,2 (spawned here, or "
                        "torchrun's); tokens are the unsharded command's")
    p.add_argument("--mesh-rules", default=None,
                   choices=sorted(sharding.SERVE_TABLES),
                   help="sharding rule table for --mesh (default "
                        "serve_exact, heads and slots split; "
                        "serve_dshard_exact splits slots only; both "
                        "bit-identical to unsharded; serve also splits "
                        "the output and down projections' rows and the "
                        "vocab: partial sums, tokens equal up to "
                        "near-ties)")
    p.add_argument("--telemetry", action="store_true",
                   help="per-request latency tracing + phase timers for "
                        "--continuous/--paged (DESIGN.md §12): TTFT/TPOT/"
                        "queue-wait percentiles and a structured event "
                        "trace; tokens are the same with it off")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="flush the event trace as JSONL to PATH (implies "
                        "--telemetry; the first line is a meta record with "
                        "the schema version and the ring's drop count)")
    p.add_argument("--profile-ticks", type=int, default=0, metavar="N",
                   help="capture the first N engine ticks with "
                        "torch.profiler (implies --telemetry; a Chrome "
                        "trace, loadable in perfetto)")
    p.add_argument("--profile-dir", default=None,
                   help="output directory for --profile-ticks (default "
                        "nldpe_profile under the working directory)")
    p.add_argument("--metrics", action="store_true",
                   help="print the engine's metrics registry as Prometheus "
                        "text after the run")
    p.add_argument("--async-serve", action="store_true",
                   help="drive the engine demo through the async "
                        "dispatch/drain pipeline with bucketed prefill "
                        "(DESIGN.md §14); the same tokens as the tick loop")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def _report(label: str, eng, comps, dt: float, extra: str = "") -> None:
    n_tok = sum(len(c.tokens) for c in comps)
    print(f"[serve] {label} on {eng.device}: {len(comps)} requests, "
          f"{n_tok} tokens in {dt * 1e3:.0f} ms "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s, {eng.max_slots} slots"
          f"{extra})")


def _runner(eng, args):
    """The engine, or with ``--async-serve`` the async pipeline over it."""
    if not args.async_serve:
        return eng
    from .async_engine import AsyncServeEngine
    return AsyncServeEngine(eng)


def _report_async(runner, eng, args) -> None:
    if not args.async_serve:
        return
    a = eng.metrics.snapshot()["async"]
    print(f"  async: {a['dispatched_ticks']} dispatched ticks, max "
          f"inflight {a['max_inflight']}/{a['drain_depth']}, "
          f"{a['pipeline_flushes']} pipeline flushes; prefill buckets "
          f"{eng._bucket_sizes} (x{eng.prefill_chunk} tok), "
          f"{eng.prefill_pad_chunks} pad chunks")
    runner.close()


def _report_obs(eng, args) -> None:
    """The telemetry story after an engine demo: latency percentiles, the
    phase walls, the JSONL trace and profiler output if asked for, and the
    registry as Prometheus text with ``--metrics``."""
    tel = eng.telemetry
    if tel is not None:
        tel.close()                     # stops a still-open profiler trace
        s = tel.summary()

        def ms(x):
            return "-" if x is None else f"{x * 1e3:.1f}ms"

        tt, tp, qw = s["ttft_s"], s["tpot_s"], s["queue_wait_s"]
        print(f"  telemetry: {s['requests_finished']} finished / "
              f"{s['ticks']} ticks; TTFT p50/p99 {ms(tt['p50'])}/"
              f"{ms(tt['p99'])}, TPOT p50/p99 {ms(tp['p50'])}/"
              f"{ms(tp['p99'])}, queue-wait p99 {ms(qw['p99'])}")
        for phase, d in s["phases"].items():
            print(f"    phase {phase:>9}: {d['seconds'] * 1e3:8.1f} ms "
                  f"over {d['calls']} calls")
        if args.trace_out:
            n = tel.flush_jsonl(args.trace_out)
            print(f"    trace: {n} events ({tel.trace.dropped} dropped) "
                  f"-> {args.trace_out}")
        if args.profile_ticks:
            prof = s["profiler"]
            print(f"    profiler: first {args.profile_ticks} ticks -> "
                  f"{prof['trace'] or prof['error']}")
    if args.metrics:
        print(eng.metrics.prometheus_text(), end="")


def _mesh_shape(text: str) -> tuple[int, int]:
    try:
        dp, tp = (int(v) for v in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh takes DP,TP (two integers), got {text!r}") from None
    if dp < 1 or tp < 1:
        raise argparse.ArgumentTypeError("--mesh DP,TP must be >= 1")
    return dp, tp


def _rank_run(argv, device):
    """One spawned rank of ``--mesh``: the CLI again, inside the process
    group (``device``, the rank's, is found again from ``--device``)."""
    return run(argv)


def run(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    _validate_args(p, args)
    mesh = None
    if args.mesh:
        dp, tp = args.mesh
        if not mesh_lib.in_process_group():
            # spawn the ranks; each runs this command inside the group
            out = mesh_lib.run_ranks(
                _rank_run, dp * tp,
                (sys.argv[1:] if argv is None else list(argv),),
                device=args.device or "cuda")
            return out[0]
        mesh = mesh_lib.serve_mesh(dp, tp, mesh_lib.rank_device(
            torch.device(args.device or "cuda"), mesh_lib.world_rank(),
            dp * tp))
        if mesh.rank:
            sys.stdout = open(os.devnull, "w")   # rank 0 reports
    device = (mesh.device if mesh is not None
              else torch.device(args.device) if args.device else None)
    tel = None
    if args.telemetry or args.trace_out or args.profile_ticks:
        tel = Telemetry(profile_ticks=args.profile_ticks,
                        profile_dir=args.profile_dir)
    cfg = get_config(args.arch, reduced=True)
    nldpe = NLDPEConfig(enabled=args.nldpe or args.fused,
                        fused_dual_compute=args.fused)
    gen = torch.Generator(device=device or "cuda")
    gen.manual_seed(args.seed)
    params = lm.init_params(cfg, generator=gen, device=device)
    rng = np.random.default_rng(args.seed)
    max_len = args.prompt_len + args.gen_len

    if args.paged:
        sys_len = min(args.system_prompt_len, args.prompt_len)
        system = tuple(int(t) for t in rng.integers(0, cfg.vocab_size,
                                                    sys_len))
        reqs = [Request(rid=i,
                        tokens=system + tuple(int(t) for t in rng.integers(
                            0, cfg.vocab_size, int(rng.integers(1, max(
                                2, args.prompt_len - sys_len + 1))))),
                        max_new_tokens=int(rng.integers(2, args.gen_len + 1)),
                        arrival=int(rng.poisson(2) * i),
                        priority=(1 if args.priority
                                  and i % args.priority == args.priority - 1
                                  else 0))
                for i in range(args.requests)]
        drift = fidelity = None
        if args.drift is not None or args.fault_rate:
            drift = DriftInjection(
                model=DriftModel(nu=args.drift or 0.0, t0=args.drift_dt,
                                 fault_rate=args.fault_rate),
                seed=args.seed, dt_step=args.drift_dt,
                reprogram_s=10 * args.drift_dt)
            # short demo traces: decide every 4 spec ticks so the ladder
            # shows within a few dozen requests
            fidelity = FidelityPolicy(window=4)
        eng = PagedServeEngine(cfg, params, max_slots=args.slots,
                               max_len=max_len, nldpe=nldpe,
                               page_size=args.page_size,
                               num_pages=args.num_pages,
                               host_cache_pages=args.host_cache_pages,
                               spec_k=args.spec,
                               spec_draft=NLDPEConfig(
                                   enabled=args.spec_full_analog),
                               drift=drift, fidelity=fidelity,
                               kv_quant=args.kv_quant, device=device,
                               telemetry=tel, mesh=mesh,
                               rules=args.mesh_rules,
                               prefill_buckets=args.async_serve or None)
        runner = _runner(eng, args)
        t0 = time.perf_counter()
        comps = runner.run(reqs)
        dt = time.perf_counter() - t0
        st = eng.stats
        mode = f", spec_k={args.spec}" if args.spec else ""
        if args.kv_quant:
            mode += f", kv_quant={args.kv_quant}"
        _report("paged", eng, comps, dt, f", {eng.pool.num_pages} pages x "
                f"{args.page_size} tok{mode}")
        print(f"  prefix hits {st['hits']}/{st['lookups']}, prefill tokens "
              f"saved {st['prefill_tokens_saved']}, cow forks "
              f"{st['cow_forks']}, evicted {st['evicted']}")
        if args.host_cache_pages or args.priority:
            print(f"  tiers: spilled {st['spilled']}, restored "
                  f"{st['restored']}, host {eng.pool.host_used}/"
                  f"{eng.pool.host_pages} pages; preempts {eng.preempts}, "
                  f"resumes {eng.resumes}")
        if args.spec:
            sp = eng.spec_stats
            n_tok = sum(len(c.tokens) for c in comps)
            print(f"  speculative: {sp['spec_steps']} steps, accepted "
                  f"{sp['accepted']}/{sp['drafted']} drafts "
                  f"({sp['acceptance_rate']:.1%} — the analog-fidelity "
                  f"signal), {n_tok / max(sp['spec_steps'], 1):.2f} "
                  f"tokens/verify pass")
        if drift is not None:
            fs = eng.fidelity_stats
            ev = "".join(f"\n    {e['event']:>9} @ t={e['t']:.0f}s "
                         f"(spec_k -> {e['spec_k']}, ewma={e['ewma']})"
                         for e in fs["events"]) or " (none)"
            print(f"  fidelity loop: vclock {fs['vclock_s']:.0f}s, "
                  f"{fs['reprograms']} reprograms "
                  f"({fs['downtime_s']:.0f}s downtime), "
                  f"{fs['fault_fraction']:.2%} cells stuck, live spec_k "
                  f"{fs['spec_k_live']}; events:{ev}")
    elif args.continuous:
        reqs = [Request(rid=i,
                        tokens=tuple(int(t) for t in rng.integers(
                            0, cfg.vocab_size,
                            int(rng.integers(2, args.prompt_len + 1)))),
                        max_new_tokens=int(rng.integers(2, args.gen_len + 1)),
                        arrival=int(rng.poisson(2) * i))
                for i in range(args.requests)]
        eng = ServeEngine(cfg, params, max_slots=args.slots, max_len=max_len,
                          nldpe=nldpe, device=device, telemetry=tel,
                          mesh=mesh, rules=args.mesh_rules,
                          prefill_buckets=args.async_serve or None)
        runner = _runner(eng, args)
        t0 = time.perf_counter()
        comps = runner.run(reqs)
        dt = time.perf_counter() - t0
        _report("continuous", eng, comps, dt, f", {eng.tick} ticks")
    else:
        return _lockstep(args, cfg, params, nldpe, rng, max_len)
    _report_async(runner, eng, args)
    _report_obs(eng, args)
    if mesh is not None:
        print(f"  mesh: {args.mesh} over ('data', 'model'), rules "
              f"{eng.rules.name}, backend "
              f"{mesh_lib.describe_backend(mesh.backend, mesh.device)}")
    if eng.moe_stats:
        m = eng.moe_stats
        print(f"  moe: {m['dropped_prefill']} live assignments dropped "
              f"over {m['prefill_forwards']} prefill chunks "
              f"({m['dropped_pad_prefill']} of padding rows), "
              f"{m['dropped_decode']} over {m['decode_forwards']} decode "
              f"steps ({m['dropped_pad_decode']} of padding rows; capacity "
              f"factor {cfg.moe.capacity_factor})")
    for c in comps[:4]:
        print(f"  rid={c.rid} admitted@{c.admitted_tick} "
              f"finished@{c.finished_tick} [{c.finish_reason}] "
              f"tokens={c.tokens[:8]}")
    return comps


def _lockstep(args, cfg, params, nldpe, rng, max_len):
    """The default branch: prefill a batch of prompts, then decode it."""
    dev = params["embed"]["table"].device
    params = lm.serving_params(params, cfg, nldpe)
    cache = lm.init_model_cache(cfg, args.batch, max_len, device=dev)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    prefill = build_prefill_step(cfg, nldpe=nldpe)
    t0 = time.perf_counter()
    last_logits, cache = prefill(params, cache, prompts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    if args.python_loop:
        gen, cache = python_loop_decode(build_decode_step(cfg, nldpe=nldpe),
                                        params, cache, tok, args.prompt_len,
                                        args.gen_len)
    else:
        generate = build_generate_fn(cfg, args.gen_len, nldpe=nldpe)
        gen, cache = generate(params, cache, tok, args.prompt_len)
    gen = gen.cpu()
    dt = time.perf_counter() - t0
    print(f"[serve] decoded {args.gen_len - 1} steps in {dt * 1e3:.0f} ms "
          f"({dt / max(args.gen_len - 1, 1) * 1e3:.1f} ms/tok, "
          f"{'python loop' if args.python_loop else 'generate fn'}); "
          f"sample row: {gen[0, :12].tolist()}")
    return gen


if __name__ == "__main__":
    run()
