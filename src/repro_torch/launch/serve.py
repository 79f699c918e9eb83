"""Serve CLI of the port: the paged-engine demo of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --paged [--nldpe | --fused]

Serves a seeded trace of requests sharing a system prompt through
``PagedServeEngine`` on the reduced config of ``--arch`` (as the JAX CLI
does), with seeded random weights, on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.engine import NLDPEConfig
from ..models import lm
from .engine import PagedServeEngine, Request


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--paged", action="store_true", required=True,
                   help="serve through the paged engine (the only engine "
                        "the port has)")
    p.add_argument("--arch", default="qwen2_5_3b")
    p.add_argument("--nldpe", action="store_true",
                   help="NL-DPE numerics (ACAM activations, log-domain "
                        "DMMul and softmax)")
    p.add_argument("--fused", action="store_true",
                   help="NL-DPE numerics with the fused crossbar->ACAM "
                        "kernel on every MLP gate")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-len", type=int, default=32)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=None)
    p.add_argument("--system-prompt-len", type=int, default=24)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def run(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device) if args.device else None
    cfg = get_config(args.arch, reduced=True)
    nldpe = NLDPEConfig(enabled=args.nldpe or args.fused,
                        fused_dual_compute=args.fused)
    gen = torch.Generator(device=device or "cuda")
    gen.manual_seed(args.seed)
    params = lm.init_params(cfg, generator=gen, device=device)
    rng = np.random.default_rng(args.seed)
    sys_len = min(args.system_prompt_len, args.prompt_len)
    system = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, sys_len))
    reqs = [Request(rid=i,
                    tokens=system + tuple(int(t) for t in rng.integers(
                        0, cfg.vocab_size, int(rng.integers(1, max(
                            2, args.prompt_len - sys_len + 1))))),
                    max_new_tokens=int(rng.integers(2, args.gen_len + 1)),
                    arrival=int(rng.poisson(2) * i))
            for i in range(args.requests)]
    eng = PagedServeEngine(cfg, params, max_slots=args.slots,
                           max_len=args.prompt_len + args.gen_len,
                           nldpe=nldpe, page_size=args.page_size,
                           num_pages=args.num_pages, device=device)
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in comps)
    st = eng.stats
    print(f"[serve] paged on {eng.device}: {len(comps)} requests, {n_tok} "
          f"tokens in {dt * 1e3:.0f} ms ({n_tok / max(dt, 1e-9):.1f} tok/s, "
          f"{args.slots} slots, {eng.pool.num_pages} pages x "
          f"{args.page_size} tok)")
    print(f"  prefix hits {st['hits']}/{st['lookups']}, prefill tokens "
          f"saved {st['prefill_tokens_saved']}, cow forks "
          f"{st['cow_forks']}, evicted {st['evicted']}")
    for c in comps[:4]:
        print(f"  rid={c.rid} admitted@{c.admitted_tick} "
              f"finished@{c.finished_tick} [{c.finish_reason}] "
              f"tokens={c.tokens[:8]}")
    return comps


if __name__ == "__main__":
    run()
