#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU.  It

1. prints the card's name and power limit and builds the port's CUDA
   kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a, one process per
   source, all at once);
2. serves full-width Qwen2.5-3B (its first ``SERVE_LAYERS`` of 36 layers,
   seeded random float32 weights) through ``PagedServeEngine`` in ``OFF`` numerics — 8 requests sharing a
   256-token system prompt — and checks that every request completes, that
   the radix cache hit, and that the paged-attention kernel (A) carried it;
3. ``[serve OFF log8]``: serves the same trace through
   ``PagedServeEngine(kv_quant="log8")`` — int8 code pools with float32
   scale rows, never decoded to an fp pool — and checks that kernel A's
   code-pool variant carried every attention call (one per layer per
   forward) and reports the pool's bytes beside an f32 pool's;
   then serves 4 of the requests in ``FUSED`` numerics and checks that the
   fused crossbar->ACAM kernel (B) carried every MLP gate;
   ``[serve mesh]``: 2 ranks on the one card (``launch.mesh.run_ranks``,
   gloo with CUDA tensors: NCCL refuses two ranks on one device) serve
   the paged OFF trace on a (1, 2) mesh over f32 pools, then FUSED (B on
   each rank's half of the gate columns) and spec 2 under ``serve_exact``,
   OFF and FUSED under ``serve`` (partial sums over "model", the vocab
   split; float32 activations), then OFF on a (2, 1) mesh: under the
   exact table every rank's tokens must be the single-device engine's bit
   for bit; under ``serve`` the sharded forward's logits must be within
   ``MESH_LOGIT_TOL`` of a float32 single-device engine's (OFF) and its
   tokens that engine's but for at most ``MESH_MAX_TIES`` request
   diverging at a near-tie; each line gives kernel A's and B's launches
   per shard, per chunk and per tick and the all-gathers and all-reduces
   per chunk and per tick; kernel A on each shard of the exact OFF
   engine's pools and B on each column half of the gate must equal the
   unsharded calls' slices bit for bit; ``[train mesh]``: 2 ranks on the
   card train full-width Qwen2.5-3B cut to ``TRAIN_MESH_LAYERS`` layers
   (float32) for two AdamW steps under ``train`` at (1, 2), then
   ``train_fsdp`` at (2, 1): losses, grad norms, gradients and parameters
   must be the single-device step's on the card within the CPU tests'
   tolerances (the second step's gradients and the parameters where no
   earlier (every) step's gradient was below 1e-6), no port kernel
   launches, and
   each rank and step prints its collectives, bytes, wall and peak memory
   beside the ms of an all-reduce and a reduce-scatter at the step's
   sizes;
4. serves a lockstep batch (``launch/serve.py``: whole-prompt prefill,
   then greedy generation; Qwen2.5-3B cut to its first
   ``CUT_LAYERS`` layers, as in step 5 and ``[train]``) in ``OFF`` numerics — 8
   prompts of 512 tokens,
   32 new tokens, the prefill through the flash-attention kernel (F); the
   generate fn and the per-token loop must give the same tokens — and in
   ``FUSED`` numerics — 4 prompts of 256, 8 new tokens, the prefill
   through the log-domain flash kernel (C) and kernel B;
5. serves 4 of the paged phase's requests through the slotted
   ``ServeEngine``;
   then ``[serve spec]``: the paged OFF engine and trace with speculative
   decoding, spec_k 4 and the weights-only drafter (kernel A's decode
   instance for the drafts, its chunk instance for the verify at q_len 5),
   and ``[serve spec analog]``: the first 4 requests, 16 new tokens,
   spec_k 1 with the ``ON`` drafter (NL-DPE attention over the cache;
   the verify through kernel A at q_len 2) — every request must complete
   with the paged OFF phase's tokens (near-tie guarded on the card's
   logits), and kernel A must carry the verify (and the weights-only
   drafts); ``[serve telemetry]``: the paged OFF engine and trace with
   telemetry on — its tokens must be paged OFF's bit for bit, its event
   trace (flushed to ``build/serve_telemetry.jsonl``) must follow the
   committed schema, and it reports TTFT, TPOT and queue-wait percentiles,
   phase walls and its tokens/s beside paged OFF's; then it serves the
   trace again on the same engine, every prompt's full pages radix hits,
   and those tokens must be the first serve's bit for bit (the hit route's
   chunk gives the miss route's logits, ``prefix_route_deviation``, whose
   D — the decode step's deviation — guards the phases below);
   ``[serve spill]``: four
   384-token system prompts cycled by 16 requests through an engine whose
   112-page pool keeps two prefix chains beside the running slots, with a
   256-page host tier, and through its destroy-on-evict twin, in turns
   over two such traces — it must spill and restore (one page read back
   bitwise), tokens within the 2D guard of the unlimited-pool engine's,
   and it reports both tokens/s, the tier counters, spill and restore ms
   per page and the host bytes held;
   ``[serve preempt]``: 8 priority-0 requests fill the slots and 2
   priority-2 requests preempt two of them to the host, which resume —
   tokens within the guard of a FIFO twin's, ms per preempt and resume,
   and the priority requests' TTFT beside the twin's; ``[serve async]``:
   the async pipeline (drain depth 4) over the paged OFF engine with
   prefill buckets, tokens within the guard of paged OFF's, tokens/s
   beside paged OFF's and beside its own tick loop in turns, pad chunks,
   pipeline counters and an idle share;
   ``[serve spec
   drift]``: the ``[serve spec]`` engine with 64 new tokens per request,
   its drafter's cells drifting and sticking on a virtual clock under the
   fidelity ladder (telemetry on) — the ladder must back off and
   reprogram, kernel A must carry the verify at every live depth, the
   tokens must be paged OFF's up to near-ties of the routes the phase
   runs, and it reports the drift state's bytes, the programming and
   reprogramming seconds and the per-tick read time;
   then ``[gemma3]`` and ``[recurrentgemma]`` (the windowed and RG-LRU
   families, cut in depth), ``[qwen3moe]``: full-width Qwen3-30B-A3B cut
   to ``QWEN3MOE_LAYERS`` MoE layers through ``PagedServeEngine`` at the
   published capacity factor (kernel A on every layer, dropped
   assignments of live tokens and of padding rows counted, none at
   decode), its dropless twin through both engines and each request alone
   through the lockstep path (kernel F; tokens equal up to near-ties under
   2D; the routing flips between the routes counted) and the lockstep
   FUSED path
   (kernel C on every layer), then Llama4-Scout at 2 full-width layers
   (float32, dropless) through paged OFF (A at 40/8 heads), run-alone
   lockstep (F) and lockstep FUSED (C), ``[rwkv6]``: full-width RWKV6-3B
   through the lockstep path in ``OFF`` (generate fn == per-token loop)
   and ``ON`` — no port kernel lies on that path —; each of these four
   family phases ends with two AdamW steps at full width on views of its
   own float32 masters (``family_train``: Gemma3 one 6-layer group,
   RecurrentGemma its 5 layers, Qwen3-MoE 4 of its 8, RWKV6 all 32;
   finite losses and grad norms, peak memory under 80 GB, no port kernel
   launched); ``[paligemma]``: all
   18 layers of PaliGemma-3B (8/1 heads of 256): the lockstep path with a
   256-row image prefix before 256-token prompts (the masked prefix-LM
   route, never kernel F), ``PagedServeEngine`` on paged OFF's trace
   (kernel A's head-dim-256 instances) and each request alone through the
   lockstep path (kernel F at D 256; tokens equal up to near-ties under
   2D), and the lockstep FUSED path (kernel C at D 256, kernel B on the
   GeGLU gate), and ``[musicgen]``: MusicGen-large (32/32 heads of 64, a
   plain GELU MLP) cut to ``MUSICGEN_LAYERS`` layers through the paged
   engine (A at GQA 1), run alone through the lockstep path (F) and the
   lockstep FUSED path (C, B on the non-gated up projection);
6. holds each kernel against its plain PyTorch version on the card at the
   shapes the serve paths launch, and times kernel, plain version and a
   PyTorch library call beside the card's bound (the crossbar kernels B,
   E and G also name the tile they launched and the rates they reached;
   kernel A runs f32 and bf16 pools at Q = 1, 2, 3, 5 and 64 (decode, the
   three verify shapes, chunk prefill) and, on the log8 engine's pools, int8
   and log8 code pools; kernels F and C run at 2048 keys too, and C's
   quantize launch must give ``log_quantize``'s bits; A, F and C run their
   head-dim-256 instances at PaliGemma's and RecurrentGemma's shapes, F
   there against the windowed ``blockwise_attention`` too); the attention
   kernels' bounds name the f32 FMA and the split-TF32 tensor-core bound;
7. serves a small model on the card and on the CPU (plain versions): the
   paged engine's greedy tokens must agree, with fp, int8 and log8 pools,
   and the lockstep prefill's last logits within a stated tolerance; the
   reduced windowed models' logits, the reduced Qwen3-MoE's paged tokens,
   the reduced RWKV6's lockstep tokens, the reduced PaliGemma's logits
   with an image prefix and the reduced MusicGen's paged tokens too;
8. ``[library]``: drives the public NL-DPE kernel library at full width —
   the layer-0 MLP gate (2048 x 11008) programmed with A-SL programming
   noise, then ``crossbar_matmul`` with read noise (kernel E) and
   ``acam_apply`` (kernel D) at M = 8 and 512, held against kernel B on the
   same cells; ``nldpe_matmul_int8`` (kernel G) at three DMMul shapes, held
   against its plain version and ``nldpe_matmul(mode="fused")``; and
   ``repro_torch.quickstart.main()`` on the card (its NAF section's hard
   evaluations through kernel D) — then times D, E and G like the other
   kernels; then ``[cnn]``: ``repro_torch.train_cnn_nldpe.main`` on the
   full-width CNN (``CNNConfig()``, batch 32): 120 AdamW steps, float32,
   NL-DPE and 6x-noise accuracies, 50 crossbar-NAF steps — every ``ON``
   convolution through kernel G (15 launches per forward, each conv shape
   held against G's plain version and timed), the loss must fall, NAF
   must not hurt, and the card's ``OFF`` logits at the initial weights
   must be the CPU's within float32 tolerance (TF32 off);
9. ``[naf dt]``: NAF step 4 for ``silu`` at ``finetune_table``'s defaults
   from a corrupted table (every hard evaluation through kernel D, which
   must equal its plain version bit for bit): the table must recover by
   half; prints the MSEs, the history, D's launches and ms per evaluation;
10. ``[naf pipeline]``: ``repro_torch.naf_pipeline.main()`` on the card;
   ``[train ckpt]``: the train CLI (reduced qwen2_7b) killed at step 7,
   resumed from its step-5 checkpoint and run uninterrupted — the resumed
   losses within rtol 1e-4 of the uninterrupted ones — and a timed
   blocking save and restore of its state onto the card, bit for bit;
11. ``[train]``: full-width Qwen2.5-3B (its first ``CUT_LAYERS``
   layers) training on the float32 masters (bf16 compute, layers
   recomputed in the backward pass): one AdamW
   step, then two crossbar-NAF steps — finite losses, the seconds of each
   step's noise pass, forward plus backward and update, and the peak
   memory, under 80 GB;

then prints one JSON line with the kernels' numbers and, last, the device
line.  It exits non-zero, printing no result, if there is no GPU, if it
is not run from a checkout, or if any check fails.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # H100 SXM dense TF32 on the tensor cores
A_TOL = 1e-4                    # paged attention: f32 sums in another order
B_MAX_FLIP_FRACTION = 1e-4      # fused crossbar->ACAM: one-code flips
                                # (measured 0 at M=8, 7.6e-6 at M=512)
F_TOL = 1e-4                    # flash attention: f32 sums in another order
                                # (bf16 outputs: plus one bf16 rounding step)
C_TOL = 1.0 / 255               # log-domain flash: one exp-grid LSB, as in
                                # tests/test_fused_dual_compute.py
U32 = 2.0 ** -24                # float32 unit roundoff
# [serve spec drift]: the [serve spec] drafter (full width at
# SERVE_LAYERS layers; 3.09 B cells at all 36) aging on a virtual clock of
# DRIFT_DT seconds per spec tick; the values and why are printed with the
# phase (``drift_settings``)
DRIFT_DT = 1.0
DRIFT_NU = 2.0
DRIFT_T0 = 500.0
DRIFT_FAULT_RATE = 1e-10        # per cell and virtual second
DRIFT_REPROGRAM_S = 4 * DRIFT_DT
DRIFT_POLICY = dict(window=4, ewma_alpha=0.5, soft_threshold=0.65,
                    hard_threshold=0.45, recover_threshold=0.7,
                    reprogram_patience=1, max_reprograms=6)
DRIFT_WHY = ("benchmarks/serve_bench.py's FID_POLICY thresholds around the "
             "healthy full-width acceptance (0.724 at spec_k 4): soft 0.65 "
             "and recover 0.70 bracket it, hard 0.45 sits where the drifted "
             "drafter has lost most of its accepts; nu 2 as FID_NU; at full "
             "width acceptance falls steeply between drift factors 0.98 and "
             "0.93 (tools/drift_acceptance_curve.py), so t0 = 500 spec "
             "ticks puts factor 0.98 at tick 5 and 0.95 at tick 13: a "
             "backoff, then a reprogram inside the run's ~45 ticks. "
             "Faults: a cell's arrival is -log1p(-u) / rate for a float32 "
             "uniform u on a 2^-23 grid, so 2^-23 of the cells (368 of "
             "3.09 B at 36 layers) draw u = 0 and are stuck from birth, as "
             "in the "
             "reference, and the next arrivals come at 2^-23 / rate = 1192 "
             "virtual s, past the run: it serves with those stuck cells, "
             "which reprogramming keeps")
# [serve spill]: four system prompts of this many tokens (24 pages each)
# and a host tier of this many pages (0.26 MB each at SERVE_LAYERS = 8,
# f32)
SPILL_SYSTEM = 384
SPILL_HOST_PAGES = 256
PORT_KERNELS = ("paged_attention", "fused_crossbar_acam", "logdomain_flash",
                "log_quantize", "flash_attention", "acam_activation",
                "crossbar_vmm", "nldpe_qmatmul")
GEMMA3_LAYERS = 8               # (5 local, 1 global) + the 2-local tail
# kernel B's M at Gemma3's gate: a prefill chunk (4 x 64, the row's
# timing), an engine decode tick (4 slots), a lockstep decode step; the
# lockstep prefill's M (the prompt's length) joins them in the phase
GEMMA3_B_MS = (256, 4, 1)
GEMMA3_ATTN_LEN = 1280          # kernels F, C: a prefill within 1100-1400
B_PLAIN_ELEMENTS = 1 << 24      # outputs per call of B's plain version
RGEMMA_LAYERS = 5               # (rec, rec, local) + the (rec, rec) tail
QWEN3MOE_LAYERS = 8             # Qwen3-30B-A3B's first 8 of 48 MoE layers
QWEN3MOE_ATTN = (2, 32, 4, 512, 512, 128)   # F, C: the lockstep prefill
# the dropless twin: float32 activations (see qwen3moe_phase); a dropless
# expert buffer holds every assignment of the forward for each of the 128
# experts, so its cost grows with the rows a chunk carries, pad rows of
# idle slots included: 2 slots, chunks of 16
QWEN3MOE_TWIN = dict(max_slots=2, max_len=1024, page_size=16,
                     prefill_chunk=16, decode_block=4)
# [rwkv6]: RWKV6-3B at its full 32 layers (the phase stays within ~30 s)
RWKV6_LAYERS = 32
# each family phase's train cut (layers) and batch (rows, positions), or
# the batch alone where the phase's own layers train: two AdamW steps at
# full width, the last thing the phase does.  ~16 bytes a trained parameter (float32 master, m, v,
# and the bf16 run copy and its gradient, which become a float32
# gradient leaf by leaf): Gemma3 one group (5 local + 1 global, 3.89 B:
# ~62 GB, past the 1024 window so the band trains), RecurrentGemma the
# phase's 5 layers (2.24 B, past the 2048 window), Qwen3-MoE its first 4
# of the phase's 8 layers (3.11 B beside the 8 layers' masters),
# RWKV6 all 32 layers (3.06 B)
GEMMA3_TRAIN = (6, (1, 1280))
RGEMMA_TRAIN = (1, 2304)
QWEN3MOE_TRAIN = (4, (2, 512))
RWKV6_TRAIN = (1, 2048)
# [qwen3moe]'s Llama4-Scout: its first 2 of 48 layers at full width (d
# 5120, 40/8 heads of 128, 16 experts of d_ff 8192, top 1, vocab 202048,
# untied: 6.22 B parameters), served dropless at float32 activations
# (see llama4_scout)
LLAMA4_LAYERS = 2
# [paligemma]: image prefix rows (SigLIP's 256 patches) and text tokens of
# the lockstep prefix requests; kernels F and C at a 1280-token prefill
PALIGEMMA_PREFIX = (256, 256)
PALIGEMMA_ATTN_LEN = 1280
# [musicgen]: MusicGen-large's first this many of its 48 layers
MUSICGEN_LAYERS = 12
# [recurrentgemma]: a lockstep prefill at the window, where its windowed
# layers take kernel F (D 256) instead of the band
RGEMMA_F_LEN = 2048
# Qwen2.5-3B's first this many layers (of 36) in every phase that serves
# it, so the whole script stays within its time limit on a slow host (all
# 36 before the [paligemma] and [musicgen] phases came: one host ran the
# phases in 1117.5 s, 688 s of them these, against 828.9 s on another; 18
# before [train mesh] and the serve table's [serve mesh] cases came, 12
# until a slow host ran the whole script in 1012 s, 435 s of it these)
SERVE_LAYERS = 8
# ... and of those, this many in [serve lockstep OFF], [serve lockstep
# FUSED], [serve slotted OFF] and [train] (12 before the [qwen3moe] and
# [rwkv6] phases came)
CUT_LAYERS = 8
WINDOWED_TOL = 1e-4             # reduced windowed models, card vs CPU OFF
# [cnn]: CNNConfig() at this batch (M = 32768 at the stem and stage 0);
# the card's OFF logits against the CPU's at float32 (TF32 off)
CNN_BATCH = 32
CNN_OFF_TOL = 1e-4
CNN_G_TOP = (32768, 144, 16)    # stage 0's 3x3 convs: the row's numbers
G_SHAPES = ((512, 128, 512),    # one head's QK^T in the lockstep prefill
            (512, 512, 128),    # P . V
            (4096, 2048, 2048))  # 8 x 512 tokens through a d_model product


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


class Timer:
    """Device time of one call from CUDA events on its stream, with the
    50 MB L2 flushed before each call (the serve path finds these operands
    cold).  A spin kernel queued first keeps the device busy while the host
    queues the flush and the call, so the events see the call's kernels
    back to back, without the host's dispatch; if the device reached the
    call before the host had queued it, the spin doubles and the sample is
    taken again.  The flush reads a 128 MB buffer (a read leaves no dirty
    lines for the timed call to write back).  ``call_ms`` is the same event
    time without the spin: host dispatch included."""

    source = "cuda-events behind a spin kernel (host dispatch hidden)"

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.ones(16 << 20, dtype=torch.int64,
                                    device="cuda")
        self.spin_cycles = 1 << 22          # ~2 ms at the H100's clock

    def _sample_ms(self, fn, spin: bool) -> float:
        torch = self.torch
        while True:
            torch.cuda.synchronize()
            if spin:
                torch.cuda._sleep(self.spin_cycles)
            self.flush_buf.max()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            exposed = e0.query()            # device waited on the host
            torch.cuda.synchronize()
            if not (spin and exposed):
                return e0.elapsed_time(e1)
            check(self.spin_cycles < 1 << 32, "timer: host dispatch of the "
                  "timed call outlasts any spin")
            self.spin_cycles *= 2

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> tuple[float, float]:
        """(device ms per call, event ms per call with host dispatch)."""
        for _ in range(warmup):
            fn()
        busy = sum(self._sample_ms(fn, True) for _ in range(iters))
        call = sum(self._sample_ms(fn, False) for _ in range(iters))
        return busy / iters, call / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def attn_bound(nbytes: float, flops: float, products: int,
               fma_share: float = 0.0) -> dict:
    """The bound of an attention call, with its two operation bounds named:
    all ``flops`` as f32 FMAs (67 TFLOP/s), and all as split-TF32 products
    on the tensor cores (``products`` TF32 products per f32 product: 3 for
    f32 operands, 2 where one side is bf16, 495 TFLOP/s dense).  The
    operations take the faster of the two, except ``fma_share`` of them,
    which must be f32 FMAs (kernel C's scores: split TF32 moves their
    grid codes).  ``bound_ms`` is the larger of that and the bytes."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_fma = flops / F32_FLOPS_PER_S * 1e3
    t_tc = products * flops / TF32_FLOPS_PER_S * 1e3
    t_ops = fma_share * t_fma + (1 - fma_share) * min(t_fma, t_tc)
    return {"bound_ms": max(t_b, t_ops),
            "bound_by": "bytes" if t_b >= t_ops else "operations",
            "bound_f32_fma_ms": t_fma, "bound_tf32_split_ms": t_tc,
            "tf32_products": products, "bound_fma_share": fma_share}


def achieved(nbytes: float, flops: float, ms: float) -> dict:
    """The rates a call of ``ms`` device milliseconds reached on the bytes
    and operations its bound counts."""
    return {"achieved_gb_per_s": nbytes / ms / 1e6,
            "achieved_tflop_per_s": flops / ms / 1e9}


def make_trace(cfg, n: int, max_new: int, base_tick: int):
    from repro_torch.launch.engine import Request
    rng = np.random.default_rng(SEED)
    system = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 256))
    reqs = []
    for i in range(n):
        suffix = tuple(int(t) for t in rng.integers(
            0, cfg.vocab_size, int(rng.integers(64, 449))))
        reqs.append(Request(rid=i, tokens=system + suffix,
                            max_new_tokens=max_new,
                            arrival=base_tick + 2 * i))
    return reqs


def serve(torch, engine, reqs, counter, label: str) -> dict:
    """Warm up on a throwaway request, zero the kernel counters, drive the
    trace through ``engine.run`` and check the completions.  ``counter`` is
    the kernel wrapper the path must launch (None for the slotted OFF
    path, which launches none of the port's kernels); a paged engine must
    also hit its radix cache.  The result carries each request's tokens
    (not printed) and kernel A's launches by (q_len, instance)."""
    from repro_torch.launch.engine import Request
    from repro_torch.nn import attention
    engine.run([Request(rid=-1, tokens=(1, 2, 3), max_new_tokens=2,
                        arrival=engine.tick)])
    base = engine.tick
    paged = hasattr(engine, "pool")
    # the trace's own pool counters (an engine may have served before)
    st0 = dict(engine.stats) if paged else {}
    reqs = [dataclasses.replace(r, arrival=base + r.arrival) for r in reqs]
    by_shape: dict = {}
    plain_a = attention.paged_attention

    def tallied(q, k_pages, v_pages, bt, lengths, **kw):
        from repro_torch.kernels.paged_attention.ops import (
            paged_attention, plan)
        before = paged_attention.launches
        out = plain_a(q, k_pages, v_pages, bt, lengths, **kw)
        kind = (2 if kw.get("kv_quant") else
                0 if k_pages.dtype == torch.float32 else 1)
        inst = plan(q.shape[0], k_pages.shape[1],
                    q.shape[1] // k_pages.shape[1] * q.shape[2],
                    bt.shape[1], k_pages.shape[2], q.shape[3],
                    kind).instance
        key = f"q_len={q.shape[2]} {inst}"
        by_shape[key] = (by_shape.get(key, 0) + paged_attention.launches
                         - before)
        return out

    attention.paged_attention = tallied
    zero_counts()
    if getattr(engine, "telemetry", None) is not None:
        engine.telemetry.reset()        # the trace's events alone
    engine.prefill_seconds = engine.decode_seconds = 0.0
    engine.decode_ticks = 0
    engine.reset_moe_stats()            # the trace's MoE drops alone
    if getattr(engine, "spec_k", 0):
        engine.reset_window()           # the trace's spec counters alone
        engine.spec_draft_seconds = 0.0
    # the path's launches inside each prefill chunk and each decode tick
    split = {"prefill_chunk": [0, 0], "decode_tick": [0, 0]}

    def counted(fn, key):
        def call(*args, **kwargs):
            before = 0 if counter is None else counter.launches
            out = fn(*args, **kwargs)
            split[key][0] += 1
            split[key][1] += (0 if counter is None
                              else counter.launches - before)
            return out
        return call
    engine._chunk = counted(engine._chunk, "prefill_chunk")
    engine.step = counted(engine.step, "decode_tick")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        comps = engine.run(reqs)
    finally:
        attention.paged_attention = plain_a
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del engine._chunk, engine.step
    launches = {fn.__name__: fn.launches for fn in counters()}
    from repro_torch.kernels.paged_attention.ops import paged_attention
    pool_launches = {k: v for k, v in paged_attention.pool_launches.items()
                     if v}
    if counter is not None:
        check(split["prefill_chunk"][1] + split["decode_tick"][1]
              == launches[counter.__name__], f"{label}: "
              f"{counter.__name__} launched outside prefill and decode")
    check(sorted(c.rid for c in comps) == [r.rid for r in reqs],
          f"{label}: not every request completed")
    for r, c in zip(reqs, comps):
        check(len(c.tokens) == r.max_new_tokens,
              f"{label}: rid {c.rid} has {len(c.tokens)} tokens, expected "
              f"{r.max_new_tokens}")
        check(all(0 <= t < engine.cfg.vocab_size for t in c.tokens),
              f"{label}: rid {c.rid} emitted a token outside the vocabulary")
    st = ({k: v - st0[k] for k, v in engine.stats.items()} if paged else
          {"hits": 0, "lookups": 0, "prefill_tokens_saved": 0,
           "cow_forks": 0})
    if paged:
        check(st["hits"] > 0, f"{label}: no radix prefix hit")
    if counter is not None:
        check(launches[counter.__name__] > 0,
              f"{label}: {counter.__name__} was never launched")
    n_gen = sum(len(c.tokens) for c in comps)
    n_prefill = sum(len(r.tokens) for r in reqs) - st["prefill_tokens_saved"]
    out = {"requests": len(comps), "generated_tokens": n_gen,
           "prefilled_tokens": int(n_prefill), "wall_s": wall,
           "tokens_per_s": n_gen / wall,
           "decode_ms_per_tick": engine.decode_seconds * 1e3
           / max(engine.decode_ticks, 1),
           "decode_ticks": engine.decode_ticks,
           "prefill_s": engine.prefill_seconds,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "prefix_hits": st["hits"], "lookups": st["lookups"],
           "prefill_tokens_saved": st["prefill_tokens_saved"],
           "cow_forks": st["cow_forks"], "launches": launches,
           "paged_attention_by_pool": pool_launches,
           "prefill_chunks": split["prefill_chunk"][0],
           "launches_per_prefill_chunk": split["prefill_chunk"][1]
           / max(split["prefill_chunk"][0], 1),
           "launches_per_decode_tick": split["decode_tick"][1]
           / max(split["decode_tick"][0], 1),
           "paged_attention_by_shape": by_shape}
    if engine.moe_stats:
        out["moe"] = engine.moe_stats
    print(f"[{label}] " + json.dumps(out))
    out["tokens"] = {c.rid: c.tokens for c in comps}
    return out


def serve_log8(torch, engine, f32_pool_bytes: int, reqs) -> dict:
    """``[serve OFF log8]``: the paged OFF trace over log8 code pools.
    Every attention call must go through kernel A's code-pool variant —
    one launch per layer per forward, all of them log8 — and no layer may
    decode its cache to
    an fp view on the way.  Reports the pools' bytes beside the paged OFF
    engine's f32 pools' (the same slots, pages and widths)."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.nn import attention
    decoded = [0]
    plain = attention._dequantize_kv

    def counted(*args, **kwargs):
        decoded[0] += 1
        return plain(*args, **kwargs)

    attention._dequantize_kv = counted
    try:
        res = serve(torch, engine, reqs, paged_attention, "serve OFF log8")
    finally:
        attention._dequantize_kv = plain
    n_layers = engine.cfg.n_layers
    total = res["launches"]["paged_attention"]
    check(res["paged_attention_by_pool"] == {"log8": total},
          f"serve OFF log8: kernel A launches by pool "
          f"{res['paged_attention_by_pool']}, expected all {total} log8")
    check(res["launches_per_prefill_chunk"] == n_layers,
          f"serve OFF log8: {res['launches_per_prefill_chunk']} kernel A "
          f"launches per prefill chunk, expected {n_layers}")
    check(res["launches_per_decode_tick"] == n_layers * engine.decode_block,
          f"serve OFF log8: {res['launches_per_decode_tick']} kernel A "
          f"launches per decode tick, expected "
          f"{n_layers * engine.decode_block}")
    check(decoded[0] == 0, f"serve OFF log8: {decoded[0]} cache reads "
          f"decoded the pool outside kernel A")
    qb, fb = pool_bytes(engine.cache), f32_pool_bytes
    check(fb == 2 * 4 * engine.cache["k"].numel(), "serve OFF log8: the "
          "f32 engine's pools are not the same shape")
    out = {"pool_bytes": qb, "f32_pool_bytes": fb,
           "pool_bytes_ratio": qb / fb}
    print("[serve OFF log8] " + json.dumps(out))
    return {**res, **out}


def serve_spec(torch, engine, reqs, off: dict, label: str) -> dict:
    """``[serve spec]`` / ``[serve spec analog]``: the paged OFF trace (or
    its head) through a speculative engine.  Every request completes with
    the paged OFF phase's tokens up to near-ties (``spec_tokens_agree``,
    against twice the routes' logit deviation that
    ``verify_route_deviation`` measures on the same weights); kernel A carries
    the verify chunk of every tick (one launch a layer at q_len spec_k +
    1, the chunk instance above G*Q = 16) and, with the weights-only
    drafter, the layers x spec_k draft decode steps (q_len 1, decode
    instance); the ``ON``
    drafter attends through NL-DPE attention and launches none."""
    from repro_torch.kernels.paged_attention.ops import (decode_max_rows,
                                                         paged_attention)
    k, n_layers = engine.spec_k, engine.cfg.n_layers
    res = serve(torch, engine, reqs, paged_attention, label)
    st = engine.spec_stats["window"]
    drafts_via_a = not engine.spec_draft.enabled
    per_tick = n_layers * (1 + (k if drafts_via_a else 0))
    check(res["launches_per_decode_tick"] == per_tick,
          f"{label}: {res['launches_per_decode_tick']} kernel A launches "
          f"per tick, expected {per_tick}")
    ticks = res["decode_ticks"]
    group = engine.cfg.n_heads // engine.cfg.n_kv_heads
    verify = ("decode" if group * (k + 1) <= decode_max_rows(
        engine.cfg.resolved_head_dim) else "chunk")
    want = {f"q_len={k + 1} {verify}": n_layers * ticks}
    if drafts_via_a:
        want["q_len=1 decode"] = n_layers * k * ticks
    shapes = {key: v for key, v in res["paged_attention_by_shape"].items()
              if not key.startswith(f"q_len={engine.prefill_chunk} ")}
    check(shapes == want, f"{label}: kernel A's decode-tick launches by "
          f"shape {shapes}, expected {want}")
    dev = verify_route_deviation(torch, engine, [
        reqs[i % len(reqs)] for i in range(engine.max_slots)])
    ties = spec_tokens_agree(torch, engine, reqs, res["tokens"],
                             off["tokens"], 2 * dev, label)
    draft_s = engine.spec_draft_seconds
    check(st["ticks"] == ticks, f"{label}: {st['ticks']} spec steps in "
          f"{ticks} decode ticks")
    out = {"spec_k": k, "drafter": "ON" if not drafts_via_a
           else "weights-only (log grid)",
           "acceptance_rate": st["acceptance_rate"],
           "drafted": st["drafted"], "accepted": st["accepted"],
           "spec_steps": st["ticks"],
           "tokens_per_s": res["tokens_per_s"],
           "ms_per_tick": res["decode_ms_per_tick"],
           "draft_seconds": draft_s,
           "draft_share_of_wall": draft_s / res["wall_s"],
           "draft_share_of_decode": draft_s
           / max(engine.decode_seconds, 1e-9),
           "max_memory_allocated_gb": res["max_memory_allocated_gb"],
           "verify_route_logit_deviation": dev,
           "tie_bound": 2 * dev,
           "paged_attention_per_tick_by_shape": {
               key: v / max(ticks, 1) for key, v in shapes.items()},
           "near_ties": ties}
    print(f"[{label} summary] " + json.dumps(out))
    return {**res, **out}


def verify_route_deviation(torch, engine, reqs, k: int | None = None
                           ) -> float:
    """Max |logit| difference between the two routes a spec engine takes
    to the same logits at full width: ``k + 1`` decode steps (kernel A's
    decode instance, GEMMs of height 8) against one verify chunk of
    ``k + 1`` queries (the chunk instance where G*Q > 16, GEMMs of height
    8 (k + 1)), ``k`` the engine's ``spec_k`` unless given, over the
    engine's own serving weights and the prompts of ``reqs``, one per slot
    of the engine (each prompt's tail is the chunk, its head prefilled in
    64-token chunks into a fresh paged cache)."""
    from repro_torch.models import lm
    cfg = engine.cfg
    k = engine.spec_k if k is None else k
    b, ps, n_blocks = len(reqs), engine.page_size, engine.n_blocks
    cache = lm.init_model_cache(cfg, b, engine.max_len,
                                paged=(b * n_blocks, ps), device="cuda")
    cache["bt"].copy_(torch.arange(b * n_blocks, dtype=torch.int32,
                                   device="cuda").reshape(b, n_blocks))
    head = [len(r.tokens) - (k + 1) for r in reqs]
    c = engine.prefill_chunk
    n = -(-max(head) // c) * c
    toks = torch.zeros((b, n + k + 1), dtype=torch.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.tokens)] = torch.tensor(r.tokens)
    toks = toks.cuda()
    ones = torch.ones((b,), dtype=torch.bool, device="cuda")
    ar = torch.arange(c, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        for s0 in range(0, n, c):           # pads past a head are rewritten
            lm.forward(engine.params, toks[:, s0:s0 + c], cfg, cache=cache,
                       positions=(s0 + ar).expand(b, c), write_mask=ones)
        m = torch.tensor(head, dtype=torch.int32, device="cuda")
        tail = torch.stack([toks[i, h:h + k + 1]
                            for i, h in enumerate(head)])
        other = {n_: t.clone() for n_, t in cache.items()}
        step = torch.stack([lm.decode_step(engine.params, cfg, tail[:, j],
                                           m + j, cache, write_mask=ones)
                            for j in range(k + 1)], dim=1)
        chunk = lm.forward(engine.params, tail, cfg, cache=other,
                           positions=m[:, None] + ar[:k + 1],
                           write_mask=ones)
    return (step - chunk).abs().max().item()


def spec_tokens_agree(torch, engine, reqs, got: dict, want: dict,
                      bound: float, label: str, nldpe=None) -> list:
    """Greedy spec tokens against the non-spec phase's for the same
    requests (``want`` may run longer: compare its head).  The verify
    chunk and the decode steps it stands for sum in other orders (kernel
    A's chunk and decode instances, bf16 GEMMs of other heights), so their
    logits differ by up to D (``verify_route_deviation``), and two tokens
    whose logits are within 2D can swap.  So where a request's tokens
    diverge, the card's top-2 logit margin at that position (a
    whole-prompt forward of the non-spec tokens before it, on the
    engine's verify weights) must be below ``bound`` = 2D; the rest of
    that request is then not comparable.  Returns the ties with their
    margins.  ``nldpe``: the numerics of that forward (default ``OFF``).
    """
    from repro_torch.core.engine import OFF
    from repro_torch.models import lm
    ties = []
    for r in reqs:
        a, b = got[r.rid], want[r.rid][:r.max_new_tokens]
        if a == b:
            continue
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        ctx = torch.tensor([r.tokens + tuple(b[:i])], dtype=torch.int32,
                           device="cuda")
        with torch.no_grad():
            top = torch.topk(lm.forward(engine.params, ctx, engine.cfg,
                                        mode="prefill", nldpe=nldpe or OFF
                                        )[0, -1].float(), 2).values
        margin = (top[0] - top[1]).item()
        ties.append({"rid": r.rid, "token": i, "margin": margin})
        check(margin < bound, f"{label}: rid {r.rid} diverges from the "
              f"reference tokens at token {i} with a top-2 margin of "
              f"{margin}, not below {bound}")
    return ties


def hit_reuse(plen: int, ps: int) -> int:
    """Positions a paged engine reuses when a prompt of ``plen`` tokens is
    cached whole: its full pages, and at most ``plen - 1`` (a page-aligned
    prompt forks its last page and recomputes its last token)."""
    return min(plen // ps * ps, plen - 1)


def prefix_route_deviation(torch, engine, reqs) -> dict:
    """Max |logit| difference, at full width, between the routes a paged
    engine takes to one prompt's last-token logits.  The miss route: the
    token inside the 64-query prefill chunk that holds it, the rows before
    it the prompt's tokens.  Two hit routes, the prompt's full pages in
    the cache (``hit_reuse``): the rest of the prompt as the engine runs
    it, in a 64-query chunk from the last full page on (the token at
    another row of kernel A's chunk instance, which splits at absolute
    boundaries: the same bits), and the last token alone through
    ``lm.decode_step`` (the decode instance, GEMMs of height S).  One prompt of ``reqs`` per slot of the engine, on its
    serving weights, in a fresh paged cache.  ``D`` is the larger."""
    from repro_torch.launch.spec_decode import clip_positions
    from repro_torch.models import lm
    cfg, c = engine.cfg, engine.prefill_chunk
    b, ps, n_blocks = len(reqs), engine.page_size, engine.n_blocks
    cache = lm.init_model_cache(cfg, b, engine.max_len,
                                paged=(b * n_blocks, ps), device="cuda")
    cache["bt"].copy_(torch.arange(b * n_blocks, dtype=torch.int32,
                                   device="cuda").reshape(b, n_blocks))
    plen = [len(r.tokens) for r in reqs]
    n = -(-max(plen) // c) * c
    toks = torch.zeros((b, n + c), dtype=torch.int32)
    for i, r in enumerate(reqs):
        toks[i, :plen[i]] = torch.tensor(r.tokens)
    toks = toks.cuda()
    ones = torch.ones((b,), dtype=torch.bool, device="cuda")
    ar = torch.arange(c, dtype=torch.int32, device="cuda")
    rows = torch.arange(b, device="cuda")
    last = torch.tensor([p - 1 for p in plen], dtype=torch.int32,
                        device="cuda")
    reuse = torch.tensor([hit_reuse(p, ps) for p in plen],
                         dtype=torch.int32, device="cuda")
    miss = [None] * b
    with torch.no_grad():
        for s0 in range(0, n, c):           # pads past a prompt are masked
            lg = lm.forward(engine.params, toks[:, s0:s0 + c], cfg,
                            cache=cache, positions=(s0 + ar).expand(b, c),
                            write_mask=ones)
            for i, p in enumerate(plen):
                if s0 <= p - 1 < s0 + c:
                    miss[i] = lg[i, p - 1 - s0]
        miss = torch.stack(miss)
        clip_positions(cache, ones, reuse)  # the full pages alone cached
        other = {n_: t.clone() for n_, t in cache.items()}
        tail = torch.stack([toks[i, hit_reuse(p, ps):hit_reuse(p, ps) + c]
                            for i, p in enumerate(plen)])
        chunk = lm.forward(engine.params, tail, cfg, cache=cache,
                           positions=reuse[:, None] + ar,
                           write_mask=ones)[rows, (last - reuse).long()]
        clip_positions(other, ones, last)
        step = lm.decode_step(engine.params, cfg,
                              toks[rows, last.long()], last, other,
                              write_mask=ones)
    d_chunk = (chunk - miss).abs().max().item()
    d_step = (step - miss).abs().max().item()
    return {"chunk_from_reuse": d_chunk, "decode_step": d_step,
            "D": max(d_chunk, d_step)}


def serve_telemetry(torch, engine, reqs, off: dict, label: str) -> dict:
    """``[serve telemetry]``: the paged OFF trace through the paged OFF
    engine with telemetry on.  Observation only: the tokens must be the
    paged OFF phase's bit for bit.  The event trace is flushed to JSONL and
    every line checked against the committed schema; prints the events by
    kind, TTFT, TPOT and queue wait at p50/p90/p99, the phase walls, the
    Prometheus text's length, and tokens/s beside paged OFF's (host
    overhead, not a gate).  Then the trace again on the same engine (every
    prompt's full pages radix hits): its tokens must be the first serve's
    bit for bit, and so must the hit route's chunk logits
    (``prefix_route_deviation``'s ``chunk_from_reuse`` is 0)."""
    from collections import Counter

    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.obs import EVENT_SCHEMA, SCHEMA_VERSION
    from repro_torch.obs.telemetry import BASE_FIELDS
    res = serve(torch, engine, reqs, paged_attention, label)
    check(res["tokens"] == off["tokens"], f"{label}: tokens differ from "
          f"the paged OFF phase's (telemetry must only observe)")
    tel = engine.telemetry
    path = ROOT / "build" / "serve_telemetry.jsonl"
    path.parent.mkdir(exist_ok=True)
    n = tel.flush_jsonl(path)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    check(lines[0] == {"ev": "meta", "schema_version": SCHEMA_VERSION,
                       "events": n, "dropped": 0} and len(lines) == n + 1,
          f"{label}: bad JSONL meta line {lines[0]}")
    seqs = []
    for e in lines[1:]:
        check(e["ev"] in EVENT_SCHEMA and set(e) == set(BASE_FIELDS)
              | set(EVENT_SCHEMA[e["ev"]]), f"{label}: event {e} does "
              f"not follow the schema")
        seqs.append(e["seq"])
    check(seqs == list(range(n)), f"{label}: sequence numbers not 0..n-1")
    kinds = Counter(e["ev"] for e in lines[1:])
    for ev in ("enqueue", "admit", "first_token", "finish"):
        check(kinds[ev] == len(reqs), f"{label}: {kinds[ev]} {ev} events "
              f"for {len(reqs)} requests")
    check(kinds["decode_block"] == res["decode_ticks"], f"{label}: "
          f"{kinds['decode_block']} decode_block events in "
          f"{res['decode_ticks']} ticks")
    s = tel.summary()
    prom = engine.metrics.prometheus_text()
    # the same trace again on the same engine: every prompt's full pages
    # are now radix hits (published at the first serve's completion), and
    # the rest of each prompt runs in a chunk from the last full page on,
    # another route to the same logits than the first serve's
    route = prefix_route_deviation(torch, engine, [
        reqs[i % len(reqs)] for i in range(engine.max_slots)])
    saved0 = engine.stats["prefill_tokens_saved"]
    again = reference_tokens(engine, [dataclasses.replace(
        r, rid=500 + r.rid) for r in reqs])
    want_saved = sum(hit_reuse(len(r.tokens), engine.page_size)
                     for r in reqs)
    check(engine.stats["prefill_tokens_saved"] - saved0 == want_saved,
          f"{label}: the re-serve did not hit every prompt's full pages")
    # kernel A's chunk instance cuts every sequence at absolute split
    # boundaries, and the chunk's GEMMs keep their (slots x chunk) shape,
    # so the hit route gives the miss route's bits: the re-serve is
    # bitwise the first serve
    check(route["chunk_from_reuse"] == 0.0, f"{label}: the hit route's "
          f"chunk moves the last prompt token's logits by "
          f"{route['chunk_from_reuse']}")
    check(again == {500 + rid: t for rid, t in off["tokens"].items()},
          f"{label} re-serve: tokens differ from the first serve's")
    # host overhead in turns on this engine: telemetry off, on, on, off
    # (the call sites read engine.telemetry at each tick).  Each turn
    # serves the trace's shapes with fresh suffixes, so every turn hits the
    # cached system prompt alone, as the first run did
    turns: dict = {"off": [], "on": []}
    vocab, n_sys = engine.cfg.vocab_size, 256
    for j, turn in enumerate(("off", "on", "on", "off")):
        engine.telemetry = tel if turn == "on" else None
        base = engine.tick
        fresh = [dataclasses.replace(
            r, rid=1000 * (j + 1) + r.rid, arrival=base + r.arrival,
            tokens=r.tokens[:n_sys] + tuple(
                (t + 7919 * (j + 1)) % vocab for t in r.tokens[n_sys:]))
            for r in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = engine.run(fresh)
        torch.cuda.synchronize()
        turns[turn].append(sum(len(c.tokens) for c in comps)
                           / (time.perf_counter() - t0))
    engine.telemetry = tel

    def pct(d):
        return {q: d[q] for q in ("p50", "p90", "p99")}

    out = {"events": n, "by_kind": dict(kinds), "jsonl": str(path),
           "ttft_s": pct(s["ttft_s"]), "tpot_s": pct(s["tpot_s"]),
           "queue_wait_s": pct(s["queue_wait_s"]), "phases": s["phases"],
           "prometheus_lines": len(prom.splitlines()),
           "tokens_per_s": res["tokens_per_s"],
           "paged_off_tokens_per_s": off["tokens_per_s"],
           "tokens_per_s_ratio": res["tokens_per_s"] / off["tokens_per_s"],
           "in_turns_tokens_per_s": turns,
           "in_turns_on_over_off": float(np.mean(turns["on"])
                                         / np.mean(turns["off"])),
           "tokens_equal_paged_off": True,
           "prefix_route_deviation": route,
           "reserve_tokens_equal_first_serve": True}
    print(f"[{label} summary] " + json.dumps(out))
    return {**res, **out, "route": route}


def drift_settings() -> dict:
    """The ``[serve spec drift]`` plant and policy, with why."""
    return {
        "model": {"nu": DRIFT_NU, "t0": DRIFT_T0,
                  "fault_rate": DRIFT_FAULT_RATE},
        "dt_step": DRIFT_DT, "reprogram_s": DRIFT_REPROGRAM_S,
        "policy": DRIFT_POLICY, "seed": SEED,
        "why": DRIFT_WHY}


def serve_spec_drift(torch, engine, reqs, want: dict, label: str) -> dict:
    """``[serve spec drift]``: the spec_k 4 weights-only engine with a
    drift plant, the fidelity ladder and telemetry on the paged OFF trace
    with 64 new tokens.  The ladder must back off and reprogram; kernel A
    must carry every tick's launches at its live depth (drafts at q_len 1,
    the verify at q_len k + 1, a disabled tick's decode at q_len 1); the
    tokens must equal ``want`` (the non-spec paged OFF engine's) up to
    near-ties within twice the largest verify-vs-decode deviation among
    the live depths.  Reports the ladder, acceptance per window, spec_k
    per tick, the drift state's bytes, the programming, reprogramming and
    per-tick read times, ms per tick, tokens/s and peak memory."""
    from repro_torch.core import drift as drift_lib
    from repro_torch.kernels.paged_attention.ops import (decode_max_rows,
                                                         paged_attention)
    cfg, n_layers = engine.cfg, engine.cfg.n_layers
    reads0, read_s0 = engine.drift_reads, engine.drift_read_seconds
    res = serve(torch, engine, reqs, paged_attention, label)
    events = list(engine.telemetry.trace)
    ks = [e["k"] if e["ev"] == "spec_verify" else 0 for e in events
          if e["ev"] in ("spec_verify", "decode_block")]
    check(len(ks) == res["decode_ticks"], f"{label}: {len(ks)} tick events "
          f"in {res['decode_ticks']} ticks")
    group = cfg.n_heads // cfg.n_kv_heads
    want_a: dict = {}

    def add(key, n):
        want_a[key] = want_a.get(key, 0) + n

    for k in ks:
        if k == 0:
            add("q_len=1 decode", n_layers * engine.decode_block)
            continue
        add("q_len=1 decode", n_layers * k)
        inst = ("decode" if group * (k + 1) <= decode_max_rows(
            cfg.resolved_head_dim) else "chunk")
        add(f"q_len={k + 1} {inst}", n_layers)
    shapes = {key: v for key, v in res["paged_attention_by_shape"].items()
              if not key.startswith(f"q_len={engine.prefill_chunk} ")}
    check(shapes == want_a, f"{label}: kernel A's decode-tick launches by "
          f"shape {shapes}, expected {want_a} from the live depths")
    fs = engine.fidelity_stats
    ladder = [e for e in events if e["ev"] == "fidelity"]
    kinds = [e["kind"] for e in ladder]
    check("backoff" in kinds and "reprogram" in kinds, f"{label}: the "
          f"ladder did not back off and reprogram: {kinds}")
    live = sorted({k for k in ks if k})
    slots = [reqs[i % len(reqs)] for i in range(engine.max_slots)]
    devs = {k: verify_route_deviation(torch, engine, slots, k) for k in live}
    bound = 2 * max(devs.values())
    ties = spec_tokens_agree(torch, engine, reqs, res["tokens"], want,
                             bound, label)
    verify = [e for e in events if e["ev"] == "spec_verify"]
    w = DRIFT_POLICY["window"]
    windows = [sum(e["accepted"] for e in verify[i:i + w])
               / max(sum(e["drafted"] for e in verify[i:i + w]), 1)
               for i in range(0, len(verify), w)]
    reads = engine.drift_reads - reads0
    out = {"settings": drift_settings(),
           "ladder": [{k: e[k] for k in ("tick", "kind", "spec_k", "ewma",
                                         "vclock_s")} for e in ladder],
           "reprograms": fs["reprograms"], "downtime_s": fs["downtime_s"],
           "vclock_s": fs["vclock_s"],
           "fault_fraction": fs["fault_fraction"],
           "faulted_cells": round(fs["fault_fraction"]
                                  * engine.cfg.param_count()),
           "disabled_ticks": fs["disabled_ticks"],
           "acceptance_per_window": windows,
           "spec_k_live_per_tick": ks,
           "acceptance_rate": engine.spec_stats["window"]["acceptance_rate"],
           "drift_state_bytes": drift_lib.state_bytes(engine._drift_state),
           "program_s": engine.drift_program_seconds,
           "reprogram_s_each": engine.reprogram_seconds,
           "read_ms_per_tick": (engine.drift_read_seconds - read_s0) * 1e3
           / max(reads, 1),
           "reads": reads,
           "ms_per_tick": res["decode_ms_per_tick"],
           "tokens_per_s": res["tokens_per_s"],
           "max_memory_allocated_gb": res["max_memory_allocated_gb"],
           "verify_route_logit_deviation": devs, "tie_bound": bound,
           "paged_attention_by_shape": shapes, "near_ties": ties}
    print(f"[{label} summary] " + json.dumps(out))
    return {**res, **out}


def spill_trace(cfg, turn: int = 0, n: int = 16, max_new: int = 32):
    """``[serve spill]``: four 384-token system prompts, ``n`` greedy
    requests cycling A B C D A ..., each with 32-96 random suffix tokens,
    2 ticks apart; another ``turn`` draws other prompts."""
    from repro_torch.launch.engine import Request
    rng = np.random.default_rng(SEED + 1 + 10 * turn)
    systems = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size,
                                                  SPILL_SYSTEM))
               for _ in range(4)]
    return [Request(rid=i, tokens=systems[i % 4] + tuple(
        int(t) for t in rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(32, 97)))),
        max_new_tokens=max_new, arrival=2 * i) for i in range(n)]


def synced(torch, fn, times: list):
    """``fn`` timed on the host clock behind a device sync on each side."""
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return call


SPILL_KEYS = ("spilled", "restored", "spill_dropped", "host_evicted",
              "readopted", "evicted", "hits", "prefill_tokens_saved")


def serve_spill(torch, cfg, params, paged_kw: dict, route: dict) -> dict:
    """``[serve spill]``: ``spill_trace`` on an engine whose device pool
    keeps at most two prefix chains beside the running slots, with a host
    tier of ``SPILL_HOST_PAGES`` (tier), and on its destroy-on-evict twin
    (the same pool, no host tier), in turns: tier, twin on one trace, then
    twin, tier on another of 8 requests (other system prompts, so each
    engine's second turn starts from a pool full of chains it cannot
    use).  Both engines'
    tokens are held to the unlimited-pool paged OFF engine's under the 2D
    guard (D of ``prefix_route_deviation``: a restored or re-prefilled
    chain reaches the suffix through other waves).  The tier must spill
    and restore, and the first page restored is read back through
    ``gather_page_rows`` and must be the page it was when it spilled, bit
    for bit.  Prints tokens/s of both per turn, the tier counters,
    restores per spill, prefill tokens saved against the twin, spill and
    restore ms per page behind a sync, the host bytes held and kernel A's
    launches."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.engine import PagedServeEngine
    from repro_torch.nn.attention import gather_page_rows
    traces = [spill_trace(cfg, 0), spill_trace(cfg, 1, n=8)]
    ps, slots = paged_kw["page_size"], paged_kw["max_slots"]
    chain = SPILL_SYSTEM // ps
    worst = -(-(SPILL_SYSTEM + 96 + 32 - 1) // ps)
    num_pages = slots * (worst - chain) + 2 * chain
    sizing = {"chain_pages": chain, "request_pages_max": worst,
              "private_pages_max": worst - chain, "slots": slots,
              "num_pages": num_pages,
              "formula": "slots x private pages + 2 chains",
              "host_cache_pages": SPILL_HOST_PAGES}
    print("[serve spill] pool " + json.dumps(sizing))
    engines = {kind: PagedServeEngine(cfg, params, num_pages=num_pages,
                                      host_cache_pages=host, **paged_kw)
               for kind, host in (("tier", SPILL_HOST_PAGES),
                                  ("destroy", 0))}
    tier = engines["tier"]
    spill_s, restore_s, probe, held = [], [], {}, [0]
    # until the first restore, every spilled page's device bytes are kept
    # (by payload) to hold that restore against
    kept: dict = {}
    plain_spill, plain_restore = tier._spill_page, tier._restore_page

    def spill(page):
        before = ([r.clone() for r in gather_page_rows(tier.cache, page)]
                  if "equal" not in probe else None)
        out_ = plain_spill(page)
        probe.setdefault("bytes", sum(x.nbytes for x in out_))
        if before is not None:
            kept[id(out_)] = (page, out_, before)
        held[0] = max(held[0], tier.pool.host_used + 1)
        return out_

    def restore(payload, page):
        plain_restore(payload, page)
        if "equal" not in probe and id(payload) in kept:
            spilled, _, before = kept[id(payload)]
            probe["equal"] = all(torch.equal(a, b) for a, b in zip(
                gather_page_rows(tier.cache, page), before))
            probe["page"], probe["restored_into"] = spilled, page
            kept.clear()

    tier._spill_page = synced(torch, spill, spill_s)
    tier._restore_page = synced(torch, restore, restore_s)
    turns: dict = {"tier": [], "destroy": []}
    for t, kind in ((0, "tier"), (0, "destroy"), (1, "destroy"),
                    (1, "tier")):
        eng = engines[kind]
        before = {k: eng.stats[k] for k in SPILL_KEYS}
        res = serve(torch, eng, traces[t], paged_attention,
                    f"serve spill {kind} turn {t}")
        res["delta"] = {k: eng.stats[k] - before[k] for k in SPILL_KEYS}
        turns[kind].append(res)
        eng.pool.check()
    host_end = tier.pool.host_used
    del engines, tier, eng
    torch.cuda.empty_cache()
    unlimited = PagedServeEngine(cfg, params, **paged_kw)
    ties: dict = {}
    for t, reqs in enumerate(traces):
        want = reference_tokens(unlimited, reqs)
        for kind in turns:
            ties[f"{kind} turn {t}"] = spec_tokens_agree(
                torch, unlimited, reqs, turns[kind][t]["tokens"], want,
                2 * route["D"], f"serve spill {kind} turn {t}")
    del unlimited
    torch.cuda.empty_cache()
    st = {k: sum(r["delta"][k] for r in turns["tier"]) for k in SPILL_KEYS}
    tw = {k: sum(r["delta"][k] for r in turns["destroy"])
          for k in SPILL_KEYS}
    check(st["spilled"] > 0 and st["restored"] > 0, f"serve spill: "
          f"spilled {st['spilled']}, restored {st['restored']}")
    check(probe.get("equal") is True, "serve spill: the first page restored "
          f"is not the page it was when it spilled ({probe.get('equal')})")
    tps = {k: [r["tokens_per_s"] for r in v] for k, v in turns.items()}
    ratios = [a / b for a, b in zip(tps["tier"], tps["destroy"])]
    page_bytes = probe["bytes"]
    summary = {
        "pool": sizing,
        "tokens_per_s": tps["tier"][0],
        "destroy_twin_tokens_per_s": tps["destroy"][0],
        "tokens_per_s_ratio": float(np.mean(ratios)),
        "tokens_per_s_ratio_per_trace": ratios,
        "in_turns_tokens_per_s": tps,
        "prefill_s": [r["prefill_s"] for r in turns["tier"]],
        "destroy_twin_prefill_s": [r["prefill_s"]
                                   for r in turns["destroy"]],
        **{k: st[k] for k in ("spilled", "restored", "spill_dropped",
                              "host_evicted", "readopted")},
        "restores_per_spill": st["restored"] / st["spilled"],
        "prefill_tokens_saved": st["prefill_tokens_saved"],
        "destroy_twin_prefill_tokens_saved": tw["prefill_tokens_saved"],
        "prefill_tokens_saved_vs_twin": st["prefill_tokens_saved"]
        - tw["prefill_tokens_saved"],
        "destroy_twin_evicted": tw["evicted"],
        "spill_ms_per_page": float(np.mean(spill_s)) * 1e3,
        "restore_ms_per_page": float(np.mean(restore_s)) * 1e3,
        "spill_ms_p50_max": [float(np.median(spill_s)) * 1e3,
                             max(spill_s) * 1e3],
        "restore_ms_p50_max": [float(np.median(restore_s)) * 1e3,
                               max(restore_s) * 1e3],
        "page_bytes": page_bytes,
        "host_bytes_held_max": held[0] * page_bytes,
        "host_bytes_held_end": host_end * page_bytes,
        "round_trip_page": {"spilled": probe["page"],
                            "restored_into": probe["restored_into"],
                            "bitwise": probe["equal"]},
        "kernel_a_launches": turns["tier"][0]["launches"][
            "paged_attention"],
        "destroy_twin_kernel_a_launches": turns["destroy"][0]["launches"][
            "paged_attention"],
        "max_memory_allocated_gb": turns["tier"][0][
            "max_memory_allocated_gb"],
        "tie_bound": 2 * route["D"], "near_ties": ties}
    print("[serve spill summary] " + json.dumps(summary))
    return {**summary, "launches": turns["tier"][0]["launches"],
            "twin_launches": turns["destroy"][0]["launches"]}


def preempt_trace(cfg, prioritized: bool = True):
    """``[serve preempt]``: 8 priority-0 requests of 256-token prompts (a
    64-token shared head, so the radix cache hits) and 48 new tokens fill
    the 8 slots at tick 0; 2 requests of priority 2 arrive at tick 4."""
    from repro_torch.launch.engine import Request
    rng = np.random.default_rng(SEED + 2)
    head = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 64))
    reqs = []
    for i in range(10):
        high = i >= 8
        reqs.append(Request(
            rid=i, tokens=head + tuple(int(t) for t in rng.integers(
                0, cfg.vocab_size, 192)), max_new_tokens=48,
            arrival=4 if high else 0,
            priority=2 if high and prioritized else 0))
    return reqs


def serve_preempt(torch, cfg, params, paged_kw: dict, route: dict) -> dict:
    """``[serve preempt]``: ``preempt_trace`` on the paged OFF engine with
    telemetry: the priority-2 arrivals must preempt running slots to the
    host and the victims resume; every request's tokens equal a
    never-preempted twin's (the same requests, priorities stripped, FIFO,
    a fresh engine) under the 2D guard (a resumed slot decodes in other
    co-batches).  Prints ms per preempt and per resume behind a sync (with
    the pages copied each way) and the priority requests' TTFT beside the
    twin's."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.engine import PagedServeEngine
    out = {}
    for kind in ("preempt", "fifo"):
        eng = PagedServeEngine(cfg, params, telemetry=True, **paged_kw)
        pre_s, res_s = [], []
        eng._preempt_slot = synced(torch, eng._preempt_slot, pre_s)
        eng._resume_one = synced(torch, eng._resume_one, res_s)
        reqs = preempt_trace(cfg, prioritized=kind == "preempt")
        res = serve(torch, eng, reqs, paged_attention,
                    f"serve preempt {kind}")
        ttft = {r.rid: r.ttft_s for r in eng.telemetry.records
                if r.rid in (8, 9)}
        pages = [e["pages"] for e in eng.telemetry.trace
                 if e["ev"] == "preempt"]
        res.update(preempts=eng.preempts, resumes=eng.resumes,
                   preempt_ms=[t * 1e3 for t in pre_s],
                   resume_ms=[t * 1e3 for t in res_s], ttft=ttft,
                   pages=pages)
        eng.pool.check()
        out[kind] = res
        if kind == "fifo":
            ties = spec_tokens_agree(torch, eng, reqs, out["preempt"][
                "tokens"], res["tokens"], 2 * route["D"], "serve preempt")
        del eng
        torch.cuda.empty_cache()
    p, f = out["preempt"], out["fifo"]
    check(p["preempts"] > 0 and p["resumes"] > 0, f"serve preempt: "
          f"{p['preempts']} preempts, {p['resumes']} resumes")
    check(f["preempts"] == 0, "serve preempt: the FIFO twin preempted")
    summary = {
        "preempts": p["preempts"], "resumes": p["resumes"],
        "pages_per_preempt": p["pages"],
        "preempt_ms": p["preempt_ms"], "resume_ms": p["resume_ms"],
        "ms_per_preempt": float(np.mean(p["preempt_ms"])),
        "ms_per_resume": float(np.mean(p["resume_ms"])),
        "high_priority_ttft_s": p["ttft"],
        "fifo_twin_high_priority_ttft_s": f["ttft"],
        "tokens_per_s": p["tokens_per_s"],
        "fifo_twin_tokens_per_s": f["tokens_per_s"],
        "kernel_a_launches": p["launches"]["paged_attention"],
        "tie_bound": 2 * route["D"], "near_ties": ties}
    print("[serve preempt summary] " + json.dumps(summary))
    return {**summary, "launches": p["launches"]}


def serve_async(torch, cfg, params, paged_kw: dict, off: dict,
                route: dict) -> dict:
    """``[serve async]``: ``AsyncServeEngine(drain_depth=4)`` over the
    paged OFF engine with ``prefill_buckets=True`` on the paged OFF trace:
    tokens equal the paged OFF phase's under the 2D guard; prints tokens/s
    beside paged OFF's in this call and beside the same engine's tick
    loop in turns, the pad chunks, the pipeline's counters and a profiled
    window's idle share."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.async_engine import AsyncServeEngine
    from repro_torch.launch.engine import PagedServeEngine, Request
    eng = PagedServeEngine(cfg, params, prefill_buckets=True, **paged_kw)
    a = AsyncServeEngine(eng, drain_depth=4)
    a.run([Request(rid=-1, tokens=(1, 2, 3), max_new_tokens=2,
                   arrival=a.tick)])
    reqs = make_trace(cfg, 8, 32, 0)
    base = a.tick
    reqs = [dataclasses.replace(r, arrival=base + r.arrival) for r in reqs]
    pad0 = eng.prefill_pad_chunks
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = a.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters()}
    check(launches["paged_attention"] > 0,
          "serve async: kernel A was never launched")
    pads = eng.prefill_pad_chunks - pad0
    got = {c.rid: c.tokens for c in comps}
    check(sorted(got) == [r.rid for r in reqs], "serve async: not every "
          "request completed")
    ties = spec_tokens_agree(torch, eng, reqs, got, off["tokens"],
                             2 * route["D"], "serve async")
    st = eng.metrics.snapshot()["async"]
    n_gen = sum(len(t) for t in got.values())
    prof = profile_window(torch, a, make_trace(cfg, 4, 32, 0), "serve async")
    a.close()
    # the pipeline against the tick loop in turns on this engine (sync,
    # async, async, sync; an engine is run directly only while its
    # wrapper is closed), each turn 2 requests with fresh suffixes
    turns: dict = {"sync": [], "async": []}
    vocab, n_sys = cfg.vocab_size, 256
    for j, kind in enumerate(("sync", "async", "async", "sync")):
        runner = a if kind == "async" else eng
        base = runner.tick
        fresh = [dataclasses.replace(
            r, rid=2000 + 100 * j + r.rid, arrival=base + r.arrival,
            tokens=r.tokens[:n_sys] + tuple(
                (t + 7919 * (j + 1)) % vocab for t in r.tokens[n_sys:]))
            for r in make_trace(cfg, 2, 32, 0)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        comps = runner.run(fresh)
        torch.cuda.synchronize()
        turns[kind].append(sum(len(c.tokens) for c in comps)
                           / (time.perf_counter() - t1))
        a.close()
    summary = {"drain_depth": a.drain_depth, "tokens_per_s": n_gen / wall,
               "paged_off_tokens_per_s": off["tokens_per_s"],
               "tokens_per_s_ratio": n_gen / wall / off["tokens_per_s"],
               "in_turns_tokens_per_s": turns,
               "in_turns_async_over_sync": float(np.mean(turns["async"])
                                                 / np.mean(turns["sync"])),
               "wall_s": wall, "prefill_buckets": eng._bucket_sizes,
               "prefill_pad_chunks": pads,
               "max_inflight": st["max_inflight"],
               "pipeline_flushes": st["pipeline_flushes"],
               "dispatched_ticks": st["dispatched_ticks"],
               "device_idle_share": prof["device_idle_share"],
               "kernel_a_launches": launches["paged_attention"],
               "tie_bound": 2 * route["D"], "near_ties": ties}
    print("[serve async summary] " + json.dumps(summary))
    del a, eng
    torch.cuda.empty_cache()
    return {**summary, "launches": launches}


# [serve mesh]: (mesh shape, [(label, rule table, numerics, spec_k,
# make_trace args)]), every shape over the same MESH_RANKS ranks (one
# spawn).  The exact table's cases must give the single-device phases'
# tokens bit for bit.  The serve table's (partial sums over "model", a
# split vocab) run at float32 activations against a float32 single-device
# engine, as tests/test_torch_mesh_serve.py does.  Paged OFF holds the
# route (partial sums, the vocab split) to fixed limits: the sharded
# whole-prompt forward's logits within MESH_LOGIT_TOL of one device's, and
# at most MESH_MAX_TIES requests of a rank diverging, each where the
# single-device top-2 margin is below MESH_TIE_MARGIN (the CPU tests'
# rule).  FUSED runs the same route, but its crossbar and ACAM quantize:
# a code that the partial sums' last bit moves across a boundary moves
# the logits by far more (D 0.197 at float32, 3 of 4 requests diverging,
# NVIDIA H100 80GB HBM3 at 700 W), so its D must stay below
# MESH_FUSED_D_OF_SCALE of the single-device logits' standard deviation
# over the vocab (a broken route moves them by about that deviation), and
# each diverging request must sit at a margin below 2D; what FUSED adds
# to the route (kernel B per column half, the gate magnitude's
# all-reduce) is held bitwise by the exact table's FUSED case
MESH_RANKS = 2
MESH_CASES = (((1, 2), (("OFF", "serve_exact", "OFF", 0, (8, 32, 0)),
                        ("FUSED", "serve_exact", "FUSED", 0, (4, 16, 0)),
                        ("spec2", "serve_exact", "OFF", 2, (4, 16, 0)),
                        ("serve OFF", "serve", "OFF", 0, (8, 32, 0)),
                        ("serve FUSED", "serve", "FUSED", 0, (4, 16, 0)))),
              ((2, 1), (("OFF", "serve_exact", "OFF", 0, (8, 32, 0)),)))
MESH_LOGIT_TOL = 1e-4
MESH_TIE_MARGIN = 0.02
MESH_MAX_TIES = 1
MESH_FUSED_D_OF_SCALE = 0.5
MESH_KEEP = ("tokens", "launches", "wall_s", "tokens_per_s",
             "launches_per_prefill_chunk", "launches_per_decode_tick",
             "paged_attention_by_shape", "prefill_chunks", "decode_ticks",
             "decode_ms_per_tick")
MESH_D_PROMPTS = 4              # the trace's prompts D is taken over


def mesh_rank(n_layers: int, device) -> dict:
    """One rank of ``[serve mesh]``, in a process of its own on the shared
    card (``launch.mesh.run_ranks``): full-width Qwen2.5-3B cut to
    ``n_layers``, the seeded weights of the single-device phases, served
    sharded on each (data, model) mesh of ``MESH_CASES`` in turn (both of
    2 ranks, one process group) through ``serve`` (counts zeroed before
    each trace: this shard's launches).  Returns, by mesh shape, each
    case's tokens, launches, collectives and walls, the shard's local
    shapes and the ms of one all-gather."""
    import torch
    from repro_torch.launch.mesh import serve_mesh
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cut_config("qwen2_5_3b", n_layers)
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    res = {}
    for shape, cases in MESH_CASES:
        mesh = serve_mesh(*shape, device)
        res[shape] = mesh_cases(torch, mesh, cfg, params, shape, cases)
    return res


def mesh_cases(torch, mesh, cfg, params, shape: tuple, cases: tuple) -> dict:
    """``mesh_rank``'s cases on one mesh.  Each case counts its
    collectives by kind per prefill chunk and per decode tick; a serve
    table case runs at float32 activations and also gives the
    last-position logits of the trace's first ``MESH_D_PROMPTS`` prompts
    through a sharded whole-prompt forward (``mesh_deviation`` holds them
    against one device's)."""
    from repro_torch.core.engine import FUSED, OFF, NLDPEConfig
    from repro_torch.kernels.dual_compute.ops import fused_crossbar_acam
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.engine import PagedServeEngine
    from repro_torch.models import lm
    from repro_torch.parallel.context import sharding_ctx
    out = {"coords": mesh.coords}
    for label, rules, numerics, spec_k, trace in cases:
        nldpe = {"OFF": OFF, "FUSED": FUSED}[numerics]
        kw = dict(max_slots=8, max_len=1024, page_size=16, prefill_chunk=64,
                  decode_block=4, nldpe=nldpe)
        if spec_k:
            kw.update(spec_k=spec_k, spec_draft=NLDPEConfig(enabled=False))
        case_cfg = (dataclasses.replace(cfg, activation_dtype=torch.float32)
                    if rules == "serve" else cfg)
        eng = PagedServeEngine(case_cfg, params, mesh=mesh, rules=rules,
                               **kw)
        counter = (fused_crossbar_acam if numerics == "FUSED"
                   else paged_attention)
        kinds = ("all_gather", "all_reduce")
        coll = {f: dict.fromkeys(("calls",) + kinds, 0)
                for f in ("_chunk", "step")}
        current = []                     # the engine call being tallied

        def by_kind(kind):
            fn = getattr(mesh, kind)

            def call(*args, **kwargs):
                if current:
                    coll[current[-1]][kind] += len(mesh._flat(
                        args[1] if kind == "all_reduce" else args[2]))
                return fn(*args, **kwargs)
            return call

        def tallied(name, fn):
            def call(*args, **kwargs):
                current.append(name)
                try:
                    return fn(*args, **kwargs)
                finally:
                    current.pop()
                    coll[name]["calls"] += 1
            return call
        for kind in kinds:
            setattr(mesh, kind, by_kind(kind))
        eng._chunk = tallied("_chunk", eng._chunk)
        eng.step = tallied("step", eng.step)
        reqs = make_trace(case_cfg, *trace)
        try:
            res = serve(torch, eng, reqs, counter,
                        f"serve mesh {shape} rank {mesh.rank} {label}")
        finally:
            for kind in kinds:
                delattr(mesh, kind)
        keep = {k: res[k] for k in MESH_KEEP}
        # per call, the warm-up request's calls included (every chunk, and
        # every tick of one kind, issues the same collectives)
        for key, name in (("prefill_chunk", "_chunk"), ("decode_tick",
                                                        "step")):
            n = max(coll[name]["calls"], 1)
            for kind in kinds:
                keep[f"{kind}s_per_{key}"] = coll[name][kind] / n
            keep[f"collectives_per_{key}"] = sum(
                coll[name][kind] for kind in kinds) / n
        blk = eng.params["groups"]["b0"]
        keep.update(heads=blk["attn"]["wq"].shape[-2],
                    kv_heads=eng.cache["k"].shape[2],
                    gate_cols=blk["ffn"]["gate"].shape[-1],
                    down_rows=blk["ffn"]["down"].shape[-2],
                    vocab_rows=eng.params["embed"]["table"].shape[0],
                    slots=eng.cache["pos"].shape[0])
        if label == "OFF":
            keep["kernel_a_on_shard"] = kernel_a_on_shard(torch, eng)
        if rules == "serve":
            logits = []
            with torch.no_grad(), sharding_ctx(mesh, eng.rules):
                for r in reqs[:MESH_D_PROMPTS]:
                    toks = torch.tensor([r.tokens], dtype=torch.int32,
                                        device=mesh.device)
                    logits.append(lm.forward(
                        eng.params, toks, case_cfg, mode="prefill",
                        nldpe=nldpe)[0, -1].float().cpu())
            keep["d_logits"] = torch.stack(logits).numpy()   # picklable
        out[label] = keep
        del eng
        torch.cuda.empty_cache()
    # what one collective costs here: all-gathers of a decode step's
    # attention output (8 slots x 8 heads x 128, bf16) and of a chunk's
    # FFN half (8 x 64 rows x 5504 columns, bf16), and all-reduces in
    # float32 of a decode step's and a chunk's partial sums (8 x 1 and 8 x
    # 64 rows of d 2048), behind syncs
    axis = "model" if shape[1] > 1 else "data"
    for kind, name, dims, dtype in (
            ("all_gather", "decode", (8, 8, 1, 128), torch.bfloat16),
            ("all_gather", "chunk", (8, 64, 5504), torch.bfloat16),
            ("all_reduce", "decode", (8, 1, 2048), torch.float32),
            ("all_reduce", "chunk", (8, 64, 2048), torch.float32)):
        x = torch.ones(dims, dtype=dtype, device=mesh.device)
        fn = ((lambda: mesh.all_gather(x, 1, axis)) if kind == "all_gather"
              else (lambda: mesh.all_reduce(x, axis)))
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        out[f"{kind}_ms_{name}"] = (time.perf_counter() - t0) / 20 * 1e3
        out[f"{kind}_bytes_{name}"] = x.numel() * x.element_size()
    return out


# [train mesh]: full-width Qwen2.5-3B cut to TRAIN_MESH_LAYERS layers at
# float32 activations (where the CPU tests' tolerances hold), two AdamW
# steps at lr TRAIN_MESH_LR on a batch of TRAIN_MESH_BATCH (rows,
# positions) under each (rule table, mesh shape) of TRAIN_MESH_CASES on
# MESH_RANKS ranks sharing the card, held against the single-device step
# on the card at tests/test_torch_mesh_train.py's tolerances: the loss and
# grad norm within TRAIN_MESH_RTOL, the first step's gradients within
# TRAIN_MESH_GRAD_TOL of each leaf's largest, the parameters within
# TRAIN_MESH_PARAM_TOL x lr where every step's single-device gradient
# reaches TRAIN_MESH_GRAD_FLOOR.  Adam divides a gradient by its own
# magnitude: a gradient of ~1e-8 whose sign the summation order sets
# (the readout gives one to the tied embedding's rows of tokens absent
# from the batch, most of its 151936) moves its parameter by up to lr
# either way, so the two runs' parameters part there, and the second
# step's gradients part everywhere (4.1e-4 and 5.9e-4 of a leaf's largest
# on an NVIDIA H100 80GB HBM3 at 700 W: above the CPU tests' 1e-4 for
# later steps, on elements whose first gradient reaches the floor too).
# So the second
# step is held at the same point: its gradients within TRAIN_MESH_GRAD_TOL
# and its loss within TRAIN_MESH_RTOL of one device's at the sharded
# run's own first-step parameters.  The CPU tests' readings (every
# element) are printed beside the gates
TRAIN_MESH_LAYERS = 4
TRAIN_MESH_BATCH = (4, 256)
TRAIN_MESH_CASES = (("train", (1, 2)), ("train_fsdp", (2, 1)))
TRAIN_MESH_LR = 1e-3
TRAIN_MESH_RTOL = 1e-5
TRAIN_MESH_GRAD_TOL = 1e-5
TRAIN_MESH_PARAM_TOL = 0.1
TRAIN_MESH_GRAD_FLOOR = 1e-6


def train_mesh_rank(device) -> dict:
    """One rank of ``[train mesh]``, in a process of its own on the shared
    card.  Rank 0 first runs the single-device steps on the card (the
    other rank waits in the mesh's setup) and keeps their losses, grad
    norms, gradients and parameters; then both ranks run each case of
    ``TRAIN_MESH_CASES`` from the same seeded masters, and rank 0 holds
    the gathered gradients and parameters against the single-device ones.
    Returns per case and step the loss, grad norm, seconds, wall,
    collectives, bytes and peak memory, the port kernels' launches over
    the steps, the ms of an all-reduce and a reduce-scatter at the step's
    sizes, and on rank 0 the largest errors (the second step's gradients
    also against one device's at this run's own first-step
    parameters)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.drift import flatten
    from repro_torch.core.naf import unflatten
    from repro_torch.launch.mesh import serve_mesh
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import lm
    from repro_torch.nn.module import gather_tree, shard_tree
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cut_config("qwen2_5_3b", TRAIN_MESH_LAYERS),
                              activation_dtype=torch.float32)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_MESH_LR)
    b, s = TRAIN_MESH_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}

    def masters():
        return lm.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(SEED + 52), device="cuda")

    ref = None
    if dist.get_rank() == 0:
        steps, grads, params = train_mesh_steps(
            torch, build_train_step(cfg, opt_cfg), masters(), batch)
        ref = (steps, [dict(flatten(g)) for g in grads], dict(flatten(
            params)))
        del grads, params
    out = {"rank": dist.get_rank(), "cases": {}}
    for rules, shape in TRAIN_MESH_CASES:
        mesh = serve_mesh(*shape, device)
        step = build_train_step(cfg, opt_cfg, mesh=mesh, rules=rules,
                                timed=True)
        params = shard_tree(masters(), step.specs, mesh)
        # copies: a shard that is a view would keep the whole leaf alive
        params = unflatten(params, [v.clone() for _, v in flatten(params)])
        torch.cuda.empty_cache()
        snap = []

        def keep_first(p):          # gathers: every rank calls it
            full = gather_tree(p, step.specs, mesh)
            if ref is not None:
                snap.append(unflatten(full, [v.clone() for _, v in
                                             flatten(full)]))
        zero_counts()
        steps, grads, params = train_mesh_steps(torch, step, params, batch,
                                                mesh, between=keep_first)
        case = {"steps": steps,
                "launches": {fn.__name__: fn.launches for fn in counters()},
                "local": {k: tuple(params["groups"]["b0"]["ffn"][k].shape)
                          for k in ("gate", "down")}
                | {"embed": tuple(params["embed"]["table"].shape)}}
        if ref is not None:
            # one device's gradient and loss at this run's first-step
            # parameters: one step from them (fresh moments)
            at, at_grads, _ = train_mesh_steps(
                torch, build_train_step(cfg, opt_cfg), snap.pop(), batch,
                n=1)
            case.update(train_mesh_errors(
                torch, steps, grads, params, ref, step.specs, mesh,
                (dict(flatten(at_grads[0])), at[0]["loss"])))
            del at_grads
        else:                       # the gathers are collectives
            for g in grads:
                gather_tree(g, step.specs, mesh)
            gather_tree(params, step.specs, mesh)
        del grads, params
        torch.cuda.empty_cache()
        # what one collective of the step's sizes costs here: an
        # all-reduce of a layer's partial sums (this rank's rows x the
        # positions x d, float32) and a reduce-scatter of the gate's
        # gradient (d x d_ff, float32), behind syncs
        axis = "model" if shape[1] > 1 else "data"
        rows = b // (shape[0] if rules == "train" else shape[0] * shape[1])
        for kind, dims in (("all_reduce", (rows, s, cfg.d_model)),
                           ("reduce_scatter", (cfg.d_model, cfg.d_ff))):
            x = torch.ones(dims, dtype=torch.float32, device=mesh.device)
            fn = ((lambda: mesh.all_reduce(x, axis)) if kind == "all_reduce"
                  else (lambda: mesh.reduce_scatter(x, 0, axis)))
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            case[f"{kind}_ms"] = (time.perf_counter() - t0) / 5 * 1e3
            case[f"{kind}_bytes"] = x.numel() * 4
            del x
        out["cases"][f"{rules} {shape}"] = case
    return out


def train_mesh_steps(torch, step, params, batch, mesh=None, n: int = 2,
                     between=None) -> tuple:
    """``n`` steps of ``step`` from ``params`` (and fresh moments): each
    step's loss, grad norm, seconds, wall, collectives, bytes (on a
    ``mesh``) and peak memory, each step's gradients (this rank's shards;
    ``adamw.update`` wrapped to see them) and the parameters after;
    ``between(params)`` runs after each step but the last."""
    from repro_torch.optim import adamw
    opt = adamw.init(params)
    update, grads, steps = adamw.update, [], []

    def keep(c, g, state, p, **kw):
        grads.append(g)
        return update(c, g, state, p, **kw)
    adamw.update = keep
    try:
        for i in range(n):
            if i and between is not None:
                between(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0, b0 = ((mesh.collectives, mesh.bytes) if mesh is not None
                      else (0, 0))
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            st = {"loss": m["loss"].item(),
                  "grad_norm": m["grad_norm"].item(),
                  "wall_s": time.perf_counter() - t0,
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            if mesh is not None:
                st.update(seconds=m["seconds"],
                          collectives=mesh.collectives - c0,
                          bytes=mesh.bytes - b0)
            steps.append(st)
    finally:
        adamw.update = update
    del opt
    return steps, grads, params


def grad_err(got: dict, want: dict) -> float:
    """The largest gradient error over its leaf's largest gradient."""
    return max(((got[k] - w).abs().max() / w.abs().max().clamp(
        min=1e-30)).item() for k, w in want.items())


def train_mesh_errors(torch, steps, grads, params, ref, specs, mesh,
                      at_same_params) -> dict:
    """Rank 0's errors of a case against the single-device steps ``ref``
    (steps, gradients, parameters): the losses' and grad norms' relative
    errors, each step's largest gradient error over its leaf's largest
    gradient, the second step's against one device's gradient and loss
    at the sharded run's first-step parameters (``at_same_params``), and
    the parameters' largest error in lr where every (the last)
    single-device gradient reaches ``TRAIN_MESH_GRAD_FLOOR`` (with where
    it was: leaf, gradients of both steps, both packages)."""
    from repro_torch.core.drift import flatten
    from repro_torch.nn.module import gather_tree
    want_steps, want_grads, want = ref
    out = {"single_device_steps": want_steps,
           "loss_rel_err": [abs(g["loss"] - w["loss"]) / abs(w["loss"])
                            for g, w in zip(steps, want_steps)],
           "grad_norm_rel_err": [
               abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
               for g, w in zip(steps, want_steps)],
           "grad_err_of_leaf_max": []}
    got_grads = []
    for g, w in zip(grads, want_grads):
        g = dict(flatten(gather_tree(g, specs, mesh)))
        out["grad_err_of_leaf_max"].append(grad_err(g, w))
        got_grads.append(g)
    # the second step's gradients against one device's at the sharded
    # run's own first-step parameters (the gate): the same function at the
    # same point
    want_at, loss_at = at_same_params
    out["grad_err_at_same_params"] = grad_err(got_grads[1], want_at)
    out["loss_rel_err_at_same_params"] = (abs(steps[1]["loss"] - loss_at)
                                          / abs(loss_at))
    # the parameters where every step's gradient reaches the floor (the
    # gate), and where the last step's does (the CPU tests' rule, which a
    # tiny first-step gradient escapes: Adam moves it by up to lr too)
    worst = {"every_step": (0.0, None), "last_step": (0.0, None)}
    for k, p in flatten(gather_tree(params, specs, mesh)):
        diff = (p - want[k]).abs().reshape(-1)
        last = want_grads[-1][k].abs().reshape(-1) >= TRAIN_MESH_GRAD_FLOOR
        every = last.clone()
        for w in want_grads[:-1]:
            every &= w[k].abs().reshape(-1) >= TRAIN_MESH_GRAD_FLOOR
        for rule, live in (("every_step", every), ("last_step", last)):
            d = torch.where(live, diff, 0.0)
            j = int(torch.argmax(d))
            if d[j].item() > worst[rule][0]:
                worst[rule] = (d[j].item(), {
                    "leaf": "/".join(k),
                    "grads_single_device": [w[k].reshape(-1)[j].item()
                                            for w in want_grads],
                    "grads": [g[k].reshape(-1)[j].item()
                              for g in got_grads],
                    "leaf_max_grad": want_grads[-1][k].abs().max().item()})
    out["param_err_over_lr"] = worst["every_step"][0] / TRAIN_MESH_LR
    out["param_err_over_lr_last_step_floor"] = (worst["last_step"][0]
                                                / TRAIN_MESH_LR)
    out["param_worst"] = {rule: w[1] for rule, w in worst.items()}
    return out


def train_mesh_phase(torch) -> dict:
    """``[train mesh]``: training on meshes of ``MESH_RANKS`` ranks sharing
    the one card under gloo with CUDA tensors (``train_mesh_rank``): two
    AdamW steps under ``train`` at (1, 2) (heads, FFN columns and the
    vocab split over "model", partial sums all-reduced), then under
    ``train_fsdp`` at (2, 1) (the batch split, every weight gathered at
    use, its gradient reduce-scattered back).  Every loss and grad norm,
    the first step's gradients and the parameters must be the
    single-device step's on the card within the tolerances the constants
    above give, and no port kernel may launch (training is plain PyTorch
    under autograd); the second step is held against one device's at the
    sharded run's first-step parameters (the constants' comment).  Prints
    a line per case, rank and step, then the summary."""
    from repro_torch.launch.mesh import describe_backend, run_ranks
    backend = describe_backend("gloo", torch.device("cuda"))
    t0 = time.perf_counter()
    every = run_ranks(train_mesh_rank, MESH_RANKS, (), device="cuda")
    out = {"model": "qwen2_5_3b", "layers": TRAIN_MESH_LAYERS,
           "batch": list(TRAIN_MESH_BATCH), "compute_dtype": "float32",
           "backend": backend,
           "spawn_wall_s": time.perf_counter() - t0, "cases": {}}
    for rules, shape in TRAIN_MESH_CASES:
        name = f"{rules} {shape}"
        per = [r["cases"][name] for r in every]
        for r, case in enumerate(per):
            for i, st in enumerate(case["steps"]):
                print(f"[train mesh step] " + json.dumps(
                    {"case": name, "rank": r, "step": i, **st}))
                check(np.isfinite(st["loss"])
                      and np.isfinite(st["grad_norm"]),
                      f"train mesh {name}: rank {r} step {i} loss or grad "
                      f"norm is not finite")
            launched = {k: v for k, v in case["launches"].items() if v}
            check(not launched, f"train mesh {name}: rank {r} launched "
                  f"port kernels {launched} (training is plain PyTorch)")
        ref = per[0]
        for what in ("loss_rel_err", "grad_norm_rel_err"):
            check(max(ref[what]) <= TRAIN_MESH_RTOL, f"train mesh {name}: "
                  f"{what} {ref[what]} above {TRAIN_MESH_RTOL}")
        err = ref["grad_err_of_leaf_max"][0]
        check(err <= TRAIN_MESH_GRAD_TOL, f"train mesh {name}: the first "
              f"step's gradients are {err} of a leaf's largest from the "
              f"single-device step's, above {TRAIN_MESH_GRAD_TOL}")
        err = ref["grad_err_at_same_params"]
        check(err <= TRAIN_MESH_GRAD_TOL, f"train mesh {name}: the second "
              f"step's gradients are {err} of a leaf's largest from one "
              f"device's at the same parameters, above "
              f"{TRAIN_MESH_GRAD_TOL}")
        check(ref["loss_rel_err_at_same_params"] <= TRAIN_MESH_RTOL,
              f"train mesh {name}: the second step's loss is "
              f"{ref['loss_rel_err_at_same_params']} from one device's at "
              f"the same parameters, above {TRAIN_MESH_RTOL}")
        check(ref["param_err_over_lr"] <= TRAIN_MESH_PARAM_TOL,
              f"train mesh {name}: a parameter is "
              f"{ref['param_err_over_lr']} lr from the single-device "
              f"step's, above {TRAIN_MESH_PARAM_TOL}")
        out["cases"][name] = {
            "losses": [st["loss"] for st in ref["steps"]],
            "single_device_losses": [st["loss"] for st in
                                     ref["single_device_steps"]],
            "loss_rel_err": ref["loss_rel_err"],
            "grad_norm_rel_err": ref["grad_norm_rel_err"],
            "grad_err_of_leaf_max": ref["grad_err_of_leaf_max"],
            "grad_err_at_same_params": ref["grad_err_at_same_params"],
            "loss_rel_err_at_same_params": ref[
                "loss_rel_err_at_same_params"],
            "param_err_over_lr": ref["param_err_over_lr"],
            "param_err_over_lr_last_step_floor": ref[
                "param_err_over_lr_last_step_floor"],
            "param_worst": ref["param_worst"],
            "wall_s_per_rank_step": [[st["wall_s"] for st in c["steps"]]
                                     for c in per],
            "collectives_per_rank_step": [
                [st["collectives"] for st in c["steps"]] for c in per],
            "bytes_per_rank_step": [[st["bytes"] for st in c["steps"]]
                                    for c in per],
            "peak_gb_per_rank": [max(st["peak_gb"] for st in c["steps"])
                                 for c in per],
            "port_kernel_launches": 0,
            "local_shapes_rank0": ref["local"],
            **{k: ref[k] for k in ("all_reduce_ms", "all_reduce_bytes",
                                   "reduce_scatter_ms",
                                   "reduce_scatter_bytes")}}
    print("[train mesh] " + json.dumps(out))
    return out


def kernel_a_on_shard(torch, eng) -> int:
    """Kernel A on a mesh engine's own shard — this rank's layer-0 pools
    and block-table rows, as served — through ``paged_attention_sharded``
    at the phase's shapes (decode, the spec-2 verify, the chunk), held
    bitwise against this shard's slice of the unsharded call on the pools
    and table gathered from every rank (concatenations: exact).  Every
    rank calls it (it all-gathers).  Returns the q_lens checked and those
    whose output differed (checked by the parent process: a rank that
    failed here would leave its peer waiting in a collective)."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_sharded, shard_specs)
    from repro_torch.models import lm
    mesh, cfg, c = eng.mesh, eng.cfg, lm.stacks(eng.cache)["full"]
    heads = (cfg.n_heads, cfg.n_kv_heads)
    sp = shard_specs(eng.max_slots, *heads, mesh, eng.rules)
    k, v, bt = c["k"][0], c["v"][0], c["bt"]
    head_axes = sp["pool"].axes_of(1)
    gk, gv = (mesh.all_gather(t, 1, head_axes) for t in (k, v))
    gbt = mesh.all_gather(bt, 0, sp["table"].axes_of(0))
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 7)
    cases, unequal = [], []
    for q_len in (1, 3, 64):
        q = torch.randn((eng.max_slots, cfg.n_heads, q_len, k.shape[-1]),
                        generator=gen, device=mesh.device, dtype=k.dtype)
        lengths = torch.clamp(eng._pos - q_len + 1, 1,
                              c["pos"].shape[1]).to(torch.int32)
        full = paged_attention(q, gk, gv, gbt, lengths)
        got = paged_attention_sharded(
            sp["q"].local(q, mesh).contiguous(), k, v, bt,
            sp["table"].local(lengths, mesh).contiguous(), mesh, eng.rules,
            n_heads=heads[0], n_kv_heads=heads[1])
        cases.append(q_len)
        if not torch.equal(got, sp["q"].local(full, mesh)):
            unequal.append(q_len)
    return {"q_lens": cases, "unequal": unequal}


def serve_mesh_phase(torch, cfg, params, refs: dict) -> dict:
    """``[serve mesh]``: the paged engine on meshes of 2 ranks sharing the
    one card, under gloo with CUDA tensors (NCCL refuses two ranks on one
    device): at (1, 2) paged OFF, FUSED (kernel B on each rank's half of
    the gate columns) and spec 2 under ``serve_exact``, OFF and FUSED
    under ``serve``, then (2, 1) OFF.  Under the exact table every rank's
    tokens must be the single-device phases' (``refs``, by case label)
    bit for bit.  Under ``serve`` (float32 activations) each case is held
    against a float32 single-device engine run here: paged OFF's route
    deviation D (``mesh_deviation``) within ``MESH_LOGIT_TOL``, and at
    most ``MESH_MAX_TIES`` diverging requests per rank, each at a
    single-device top-2 margin below ``MESH_TIE_MARGIN``.  Each case
    reports kernel A's and
    B's launches per shard, per prefill chunk and per decode tick, its
    all-gathers and all-reduces per chunk and per tick, and its wall.
    Kernel A per shard on each exact OFF engine's own pools and table
    (``kernel_a_on_shard``, in the ranks) and kernel B on each column half
    of the gate at the phase's M must equal the unsharded calls' slices
    bit for bit.  Each process runs ``mesh_rank``."""
    from repro_torch.core.engine import FUSED, OFF
    from repro_torch.kernels.dual_compute.ops import fused_linear_acam
    from repro_torch.launch.engine import PagedServeEngine
    from repro_torch.launch.mesh import describe_backend, run_ranks
    backend = describe_backend("gloo", torch.device("cuda"))
    out = {"backend": backend, "cases": {}}
    t0 = time.perf_counter()
    every = run_ranks(mesh_rank, MESH_RANKS, (SERVE_LAYERS,), device="cuda")
    out["spawn_wall_s"] = time.perf_counter() - t0
    for shape, cases in MESH_CASES:
        ranks = [r[shape] for r in every]
        for label, rules, numerics, spec_k, trace in cases:
            name = ("fused_crossbar_acam" if numerics == "FUSED"
                    else "paged_attention")
            per = [r[label] for r in ranks]
            case = {"rules": rules, "spec_k": spec_k}
            if rules == "serve":
                nldpe = {"OFF": OFF, "FUSED": FUSED}[numerics]
                cfg32 = dataclasses.replace(cfg,
                                            activation_dtype=torch.float32)
                one = PagedServeEngine(cfg32, params, max_slots=8,
                                       max_len=1024, page_size=16,
                                       prefill_chunk=64, decode_block=4,
                                       nldpe=nldpe)
                reqs = make_trace(cfg32, *trace)
                want = reference_tokens(one, reqs)
                dev, scale = mesh_deviation(torch, one, reqs, nldpe,
                                            [p["d_logits"] for p in per])
                if numerics == "OFF":
                    limit, margin = MESH_LOGIT_TOL, MESH_TIE_MARGIN
                else:
                    limit, margin = MESH_FUSED_D_OF_SCALE * scale, 2 * dev
                check(dev <= limit, f"serve mesh {shape} {label}: the "
                      f"sharded forward's logits are {dev} from one "
                      f"device's, above {limit}")
                ties = [spec_tokens_agree(
                    torch, one, reqs, p["tokens"], want, margin,
                    f"serve mesh {shape} {label} rank {r}", nldpe)
                    for r, p in enumerate(per)]
                if numerics == "OFF":
                    for r, t in enumerate(ties):
                        check(len(t) <= MESH_MAX_TIES, f"serve mesh {shape} "
                              f"{label}: {len(t)} requests of rank {r} "
                              f"diverge from one device's, above "
                              f"{MESH_MAX_TIES}")
                case.update(compute_dtype="float32",
                            route_logit_deviation=dev, logit_limit=limit,
                            logit_std=scale, tie_margin=margin,
                            near_ties=ties)
                del one
                torch.cuda.empty_cache()
            else:
                case["tokens_equal_single_device"] = True
            for r, res in enumerate(per):
                if rules != "serve":
                    check(res["tokens"] == refs[label],
                          f"serve mesh {shape} {label}: rank {r}'s tokens "
                          f"differ from the single-device engine's")
                check(res["launches"][name] > 0,
                      f"serve mesh {shape} {label}: {name} was never "
                      f"launched on rank {r}")
            out["cases"][f"{shape} {label}"] = {
                **case,
                "kernel": name,
                "launches_per_shard": [p["launches"][name] for p in per],
                "launches_per_prefill_chunk_per_shard": [
                    p["launches_per_prefill_chunk"] for p in per],
                "launches_per_decode_tick_per_shard": [
                    p["launches_per_decode_tick"] for p in per],
                "port_launches_per_shard": [
                    {k: v for k, v in p["launches"].items() if v}
                    for p in per],
                "paged_attention_by_shape_rank0":
                    per[0]["paged_attention_by_shape"],
                "wall_s_per_shard": [p["wall_s"] for p in per],
                "tokens_per_s_rank0": per[0]["tokens_per_s"],
                "decode_ms_per_tick_rank0": per[0]["decode_ms_per_tick"],
                **{f"{k}_rank0": per[0][k] for k in per[0]
                   if k.startswith(("collectives_per", "all_gathers_per",
                                    "all_reduces_per"))},
                "local": {k: per[0][k] for k in (
                    "heads", "kv_heads", "gate_cols", "down_rows",
                    "vocab_rows", "slots")},
                "backend": backend}
            if "kernel_a_on_shard" in per[0]:
                for r, res in enumerate(per):
                    check(not res["kernel_a_on_shard"]["unequal"],
                          f"serve mesh {shape}: kernel A on rank {r}'s own "
                          f"shard is not the unsharded call's slice at "
                          f"q_len {res['kernel_a_on_shard']['unequal']}")
                out["cases"][f"{shape} {label}"]["kernel_a_on_shard"] = [
                    p["kernel_a_on_shard"]["q_lens"] for p in per]
        out[f"collective_ms {shape}"] = {
            k: ranks[0][k] for k in ranks[0]
            if k.startswith(("all_gather_", "all_reduce_"))}

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    # kernel B on each half of the gate's columns, bitwise
    gate = params["groups"]["b0"]["ffn"]["gate"][0]
    w_max = torch.amax(torch.abs(gate))
    n = gate.shape[1] // 2
    b_cases = 0
    for m_rows in (8, 512):
        x = torch.randn((m_rows, gate.shape[0]), generator=gen,
                        device="cuda")
        full = fused_linear_acam(x, gate, "silu")
        for i in range(2):
            cols = slice(i * n, (i + 1) * n)
            got = fused_linear_acam(x, gate[:, cols].contiguous(), "silu",
                                    w_max=w_max)
            check(torch.equal(got, full[:, cols]),
                  f"serve mesh: kernel B on column half {i} at M {m_rows} "
                  f"is not the unsharded call's columns")
            b_cases += 1
    torch.cuda.synchronize()
    out["kernel_a_shards_bitwise"] = sum(
        len(p["OFF"]["kernel_a_on_shard"]["q_lens"]) for r in every
        for p in r.values())
    out["kernel_b_shards_bitwise"] = b_cases
    print("[serve mesh] " + json.dumps(out))
    return out


def mesh_deviation(torch, sp, reqs, nldpe, sharded: list) -> float:
    """The serve table's route deviation D: the largest |logit| difference
    between each rank's sharded whole-prompt forward (``sharded``: the
    last-position logits of the first ``MESH_D_PROMPTS`` prompts of
    ``reqs``, ``mesh_cases``) and one device's on the serving weights
    ``sp.params`` (``sp.cfg``), and the single-device logits' standard
    deviation over the vocab (the mean over the prompts).  The output and
    down projections' partial sums add in another order than one GEMM's
    reduction."""
    from repro_torch.models import lm
    want = []
    with torch.no_grad():
        for r in reqs[:MESH_D_PROMPTS]:
            toks = torch.tensor([r.tokens], dtype=torch.int32,
                                device="cuda")
            want.append(lm.forward(sp.params, toks, sp.cfg, mode="prefill",
                                   nldpe=nldpe)[0, -1].float().cpu())
    want = torch.stack(want).numpy()
    return (max(float(np.max(np.abs(got - want))) for got in sharded),
            float(np.mean(np.std(want, axis=-1))))


def mesh_launches(res: dict, name: str) -> dict:
    """A kernel's per-shard launches in ``[serve mesh]``, by case."""
    return {case: {k: v for k, v in c.items() if k.startswith("launches")}
            for case, c in res["cases"].items() if c["kernel"] == name}


def reference_tokens(engine, reqs) -> dict:
    """Greedy tokens of ``reqs`` through a non-spec engine (fresh arrivals
    from its current tick)."""
    base = engine.tick
    reqs = [dataclasses.replace(r, arrival=base + r.arrival) for r in reqs]
    return {c.rid: c.tokens for c in engine.run(reqs)}


def path_launches(res: dict, name: str) -> dict:
    """A kernel's launches over its serve phase, in all and per step."""
    return {"launches": res["launches"][name],
            "launches_per_decode_tick": res["launches_per_decode_tick"],
            "launches_per_prefill_chunk": res["launches_per_prefill_chunk"]}


def profiled(torch, fn, label: str) -> dict:
    """Where the time goes: run ``fn`` under the CUDA profiler; the
    device's busy and idle share of the wall time and the kernels that take
    the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ka) / 1e6
    # the port's kernels, each summed over its template instances (tiles;
    # kernel A's decode and chunk instances and its split merge)
    port = {}
    for name in PORT_KERNELS:
        ms = sum(e.self_device_time_total for e in ka
                 if f"{name}_kernel" in e.key) / 1e3
        if ms:
            port[name] = {"ms": ms, "share_of_busy": ms / 1e3 / busy}
    out = {"wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1 - busy / wall,
           "top_kernels_ms": [[e.key[:90], e.self_device_time_total / 1e3]
                              for e in ka[:8]],
           "port_kernels": port}
    print(f"[{label} profile] " + json.dumps(out))
    return out


def profile_window(torch, engine, reqs, label: str) -> dict:
    """Serve ``reqs`` again under fresh rids (a paged engine now hits its
    prefix cache) under the profiler."""
    base = engine.tick
    reqs = [dataclasses.replace(r, rid=100 + r.rid, arrival=base)
            for r in reqs]
    return profiled(torch, lambda: engine.run(reqs), label)


def lockstep(torch, cfg, params, nldpe, *, batch: int, prompt_len: int,
             gen_len: int, counters_on_path: list, label: str,
             compare_loop: bool, profile: bool = True) -> dict:
    """The lockstep path of ``launch/serve.py`` on the full-width model:
    whole-prompt prefill of ``batch`` random prompts, then greedy
    generation of ``gen_len`` tokens with the generate fn (and, with
    ``compare_loop``, with ``python_loop_decode`` from a copy of the
    prefilled cache: the tokens must be identical).  Each wrapper in
    ``counters_on_path`` must launch once per layer in the prefill; its
    launches per decode step are reported and checked against the
    phase's total."""
    from repro_torch.launch.serve import (build_decode_step,
                                          build_generate_fn,
                                          build_prefill_step,
                                          python_loop_decode)
    from repro_torch.models import lm
    sp = lm.serving_params(params, cfg, nldpe)
    prefill = build_prefill_step(cfg, nldpe=nldpe)
    generate = build_generate_fn(cfg, gen_len, nldpe=nldpe)
    max_len = prompt_len + gen_len
    rng = np.random.default_rng(SEED + 2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len)),
                              dtype=torch.int32, device="cuda")
    # warm-up: a short prompt through the same steps (cuBLAS, kernel loads)
    warm = lm.init_model_cache(cfg, batch, 24, device="cuda")
    last, warm = prefill(sp, warm, prompts[:, :16])
    build_generate_fn(cfg, 3, nldpe=nldpe)(
        sp, warm, torch.argmax(last, -1).to(torch.int32), 16)
    del warm
    cache = lm.init_model_cache(cfg, batch, max_len, device="cuda")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last, cache = prefill(sp, cache, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = {fn.__name__: fn.launches for fn in counters()}
    check(bool(torch.isfinite(last).all()), f"{label}: non-finite logits")
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    spare = lm.clone_cache(cache) if compare_loop else None
    t0 = time.perf_counter()
    gen, cache = generate(sp, cache, tok, prompt_len)
    gen = gen.cpu()
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {fn.__name__: fn.launches for fn in counters()}
    steps = gen_len - 1
    check(tuple(gen.shape) == (batch, gen_len), f"{label}: tokens shape "
          f"{tuple(gen.shape)}")
    check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          f"{label}: a token outside the vocabulary")
    per = {}
    for fn in counters_on_path:
        name = fn.__name__
        in_prefill = after_prefill[name]
        in_decode = launches[name] - in_prefill
        check(in_prefill == cfg.n_layers, f"{label}: {name} launched "
              f"{in_prefill} times in the prefill, expected one per layer "
              f"({cfg.n_layers})")
        check(in_prefill + in_decode == launches[name], f"{label}: {name} "
              f"launched outside prefill and decode")
        per[name] = {"launches": launches[name],
                     "launches_per_prefill": in_prefill,
                     "launches_per_decode_step": in_decode / steps}
    out = {"batch": batch, "prompt_len": prompt_len, "gen_len": gen_len,
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": batch * prompt_len / prefill_s,
           "decode_ms_per_step": decode_s * 1e3 / steps,
           "generated_tokens_per_s": batch * steps / decode_s,
           "max_memory_allocated_gb": peak, "launches": launches,
           "per_kernel": per, "sample_row": gen[0, :12].tolist()}
    if compare_loop:
        t0 = time.perf_counter()
        loop, _ = python_loop_decode(build_decode_step(cfg, nldpe=nldpe),
                                     sp, spare, tok, prompt_len, gen_len)
        out["python_loop_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                          / steps)
        check(torch.equal(loop, gen), f"{label}: generate fn and python "
              f"loop tokens differ")
        out["loop_tokens_equal"] = True
    print(f"[{label}] " + json.dumps(out))
    if not profile:
        return out

    def again():
        c = lm.init_model_cache(cfg, batch, max_len, device="cuda")
        lg, c = prefill(sp, c, prompts)
        generate(sp, c, torch.argmax(lg, -1).to(torch.int32),
                 prompt_len)[0].cpu()
    out["profile"] = profiled(torch, again, label)
    return out


def kernel_a_inputs(engine) -> dict:
    """What the kernel-A phase reads of a served paged engine, copied so
    the engine can be freed: its layer-0 pools (and scale pools), block
    table, position-track length, decode positions and head count."""
    from repro_torch.models.lm import POOL_LEAVES
    c = engine.cache
    return {**{n: c[n][0].clone() for n in POOL_LEAVES if n in c},
            "bt": c["bt"].clone(), "length": c["pos"].shape[1],
            "pos": engine._pos.clone(), "n_heads": engine.cfg.n_heads}


def paged_attention_phase(torch, timer, fp_in: dict, launches: dict,
                          q_in: dict, qlaunches: dict,
                          spec_launches: dict, extra_cases=()) -> dict:
    """Kernel A on the OFF engine's own layer-0 pools and block tables
    (``kernel_a_inputs``): decode (Q=1), the spec verify (Q=2, the analog
    phase's and spec_k 1's; Q=3, spec_k 2's; Q=5, spec_k 4's) and chunk
    prefill (Q=64), f32 and bf16
    pools; then on the log8 engine's own layer-0 code and scale pools and
    block tables (Q=1, 64), the log8 pools as served and the same K/V
    re-encoded on the int8 grid.  Sentinel entries are written into each
    block table.  ``spec_launches`` are the spec phases' counts (and
    other phases'); ``extra_cases`` (the MoE phase's) join the row's
    cases."""
    from repro_torch.core.quantization import kv_decode
    from repro_torch.nn.attention import _quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k0, v0 = fp_in["k"], fp_in["v"]
    pools = {"log8": (q_in["k"], q_in["v"], q_in["k_scale"],
                      q_in["v_scale"])}
    kf, vf = (kv_decode(q_in[n], q_in[f"{n}_scale"], "log8")
              for n in ("k", "v"))
    (kc, ks), (vc, vs) = _quantize_kv(kf, "int8"), _quantize_kv(vf, "int8")
    pools["int8"] = (kc, vc, ks, vs)
    del kf, vf
    cases = []
    for q_len in (1, 2, 3, 5, 64):
        q = torch.randn((fp_in["bt"].shape[0], fp_in["n_heads"], q_len,
                         k0.shape[-1]), generator=gen, device="cuda")
        for pool_dtype in (torch.float32, torch.bfloat16):
            cases.append(paged_case(
                torch, timer, fp_in, q, k0.to(pool_dtype),
                v0.to(pool_dtype), {}, str(pool_dtype).split(".")[-1]))
        if q_len in (2, 3, 5):              # the verify shapes: fp pools
            continue
        for mode in ("int8", "log8"):
            kc, vc, ks, vs = pools[mode]
            cases.append(paged_case(
                torch, timer, q_in, q, kc, vc,
                dict(k_scale=ks, v_scale=vs, kv_quant=mode), mode,
                launches=qlaunches["paged_attention_by_pool"].get(mode, 0)))
    top = cases[0]                          # decode, f32 pool: the hot case
    cases += list(extra_cases)
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:114",
            **launches,
            "launches_serve_off_log8":
                qlaunches["launches"]["paged_attention"],
            **spec_launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": A_TOL, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library": "scaled_dot_product_attention on the gathered view "
                       "(code pools: gathered and plainly dequantized to "
                       "f32, the dequantization untimed)",
            "timing": timer.source, "cases": cases}


def paged_case(torch, timer, inputs: dict, q, kp, vp, qkw: dict, pool: str,
               launches: int | None = None) -> dict:
    """One kernel-A case on an engine's block table (with two sentinel
    entries written in) and decode positions (``kernel_a_inputs``): held
    against the plain version, timed beside it, SDPA and the bound.
    ``qkw`` carries the scales and grid of a code pool."""
    from repro_torch.core.quantization import kv_decode
    from repro_torch.kernels.paged_attention.ops import paged_attention, plan
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    num_pages, hkv, ps, d = kp.shape
    bt = inputs["bt"].clone()
    bt[0, 3] = num_pages                    # unmapped sentinel
    bt[1, 5] = -1                           # negative sentinel
    b, nb = bt.shape
    q_len = q.shape[2]
    lengths = torch.clamp(inputs["pos"] - q_len + 1, 1,
                          inputs["length"]).to(torch.int32)
    args = (q, kp, vp, bt, lengths)
    out = paged_attention(*args, **qkw)
    ref = paged_attention_ref(*args, **qkw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"paged_attention {pool}: "
          f"non-finite output")
    err = (out - ref).abs().max().item()
    check(err <= A_TOL, f"paged_attention q_len={q_len} {pool}: max "
          f"|kernel - plain| {err} > {A_TOL}")
    # library yardstick: SDPA on the gathered dense view (the gather, and
    # a code pool's dequantization, are not timed)
    btc = bt.long().clamp(0, num_pages - 1)
    kd = kp[btc].transpose(1, 2).reshape(b, hkv, nb * ps, d)
    vd = vp[btc].transpose(1, 2).reshape(b, hkv, nb * ps, d)
    extra = {}
    if qkw:
        mode = qkw["kv_quant"]

        def decode(x, sc):
            return kv_decode(x, sc[btc].transpose(1, 2).reshape(
                b, hkv, nb * ps), mode)
        kd, vd = decode(kd, qkw["k_scale"]), decode(vd, qkw["v_scale"])
        # an f32 pool of the decoded values gives the code variant's bits
        fp = paged_attention(q, kv_decode(kp, qkw["k_scale"], mode),
                             kv_decode(vp, qkw["v_scale"], mode), bt,
                             lengths)
        check(torch.equal(fp, out), f"paged_attention {pool}: the f32 pool "
              f"of the decoded values gives other bits")
        extra["equals_f32_pool_of_decoded_values"] = True
    allowed = lengths.long()[:, None] + torch.arange(q_len, device="cuda")
    ok_blk = ((bt >= 0) & (bt < num_pages)).repeat_interleave(ps, 1)
    mask = (torch.arange(nb * ps, device="cuda")[None, None]
            < allowed[..., None]) & ok_blk[:, None]
    qd = q.to(kd.dtype)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[:, None], enable_gqa=True)

    ms, call_ms = timer.ms(lambda: paged_attention(*args, **qkw), iters=20)
    plain_ms, _ = timer.ms(lambda: paged_attention_ref(*args, **qkw),
                           iters=5)
    lib_ms, _ = timer.ms(lib, iters=20)
    # what this run's data needs: pages below each row's length that are
    # mapped, each read once (a code pool: 1 B per element plus a 4 B scale
    # per position and head); 4*D FLOPs per attended (row, position) pair
    bt_np, len_np = bt.cpu().numpy(), lengths.cpu().numpy()
    mapped = (bt_np >= 0) & (bt_np < num_pages)
    n_pages, pairs = 0, 0
    for bi in range(b):
        need = -(-(int(len_np[bi]) + q_len - 1) // ps)
        n_pages += int(mapped[bi, :need].sum())
        valid = np.repeat(mapped[bi], ps)
        for j in range(q_len):
            pairs += int(valid[:int(len_np[bi]) + j].sum())
    per_pos = d * kp.element_size() + (4 if qkw else 0)
    nbytes = (2 * q.numel() * 4 + bt.numel() * 4 + b * 4
              + 2 * n_pages * hkv * ps * per_pos)
    flops = 4 * d * pairs * q.shape[1]
    bd = attn_bound(nbytes, flops, 2 if kp.dtype == torch.bfloat16 else 3)
    pl = plan(b, hkv, q.shape[1] // hkv * q_len, nb, ps, d,
              2 if qkw else (0 if kp.dtype == torch.float32 else 1))
    case = {"q_len": q_len, "pool": pool, "instance": pl.instance,
            "rows": pl.rows, "splits": pl.splits,
            "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, **bd, **extra}
    if launches is not None:
        case["launches"] = launches
    print("[kernel A] " + json.dumps(case))
    return case


def fused_acam_cases(torch, timer, w, ms, act: str, gen) -> list:
    """Kernel B on random (m, K) inputs, for each m of ``ms``, against the
    weight ``w`` (K, N) programmed once, with the 8-bit ``act`` table and
    its cached compiled map, as ``fused_linear_acam`` passes them: held
    against the plain version (one ACAM code on at most
    ``B_MAX_FLIP_FRACTION`` of the outputs) and timed beside the plain
    version, ``torch.matmul`` and the bound.  The plain version runs
    ``B_PLAIN_ELEMENTS // N`` rows a call (each output's interval match
    broadcasts over the table's thresholds: ~1.6 kB of temporaries an
    output), the same rows whole."""
    from repro_torch.core.acam import get_table, table_map, table_thresholds
    from repro_torch.kernels.dual_compute.ops import (fused_crossbar_acam,
                                                      program, tile_variant)
    from repro_torch.kernels.dual_compute.ref import (
        effective_weight, fused_crossbar_acam_ref)
    k, n = w.shape
    table = get_table(act, 8)
    lo, hi = table_thresholds(table, "cuda")
    step = float(table.out_spec.step)
    kw = dict(out_lo=float(table.out_spec.lo), out_step=step)
    acam_map = table_map(table, "cuda")
    cells, inv = program(w)
    w_eff = effective_weight(*cells, inv)
    rows = max(1, B_PLAIN_ELEMENTS // n)

    def plain(x):
        return torch.cat([fused_crossbar_acam_ref(
            x[i:i + rows], *cells, inv, lo, hi, **kw)
            for i in range(0, x.shape[0], rows)])

    cases = []
    for m in ms:
        t0 = time.perf_counter()
        x = torch.randn((m, k), generator=gen, device="cuda")
        args = (x, *cells, inv, lo, hi)
        out = fused_crossbar_acam(*args, **kw, acam_map=acam_map)
        ref = plain(x)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = diff.max().item()
        flips = (diff > 0).float().mean().item()
        check(err <= step * 1.0001, f"fused_crossbar_acam {act} M={m} "
              f"K={k} N={n}: max |kernel - plain| {err} > one ACAM code "
              f"({step})")
        check(flips <= B_MAX_FLIP_FRACTION, f"fused_crossbar_acam {act} "
              f"M={m} K={k} N={n}: {flips:.2e} of outputs differ "
              f"(> {B_MAX_FLIP_FRACTION})")
        del out, ref, diff
        ms_, call_ms = timer.ms(lambda: fused_crossbar_acam(
            *args, **kw, acam_map=acam_map), iters=10)
        plain_ms, _ = timer.ms(lambda: plain(x), iters=3)
        lib_ms, _ = timer.ms(lambda: torch.matmul(x, w_eff), iters=10)
        nbytes = 4 * (m * k + 4 * k * n + m * n + 2 * lo.numel() + 1)
        flops = 2 * m * k * n + 5 * k * n
        bms, by = bound(nbytes, flops)
        case = {"m": m, "k": k, "n": n, "act": act,
                "tile": tile_variant(m, n), "max_abs_err": err,
                "one_code": step, "flipped_fraction": flips, "ms": ms_,
                "call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                **achieved(nbytes, flops, ms_),
                "wall_s": time.perf_counter() - t0}
        print("[kernel B] " + json.dumps(case))
        cases.append(case)
    return cases


def fused_acam_phase(torch, timer, params, launches: dict,
                     extra_cases=()) -> dict:
    """Kernel B at every M the Qwen2.5-3B serve paths give the MLP gate: 8
    (a paged decode tick over 8 slots), 4 (a lockstep FUSED decode step),
    512 (a paged prefill chunk of 8 x 64) and 1024 (the lockstep FUSED
    prefill, 4 x 256), and at M = 1 and 16, the edges of the small tile;
    K=2048, N=11008, the layer-0 gate weight, the 8-bit silu table.
    ``extra_cases`` (the Gemma3 and RecurrentGemma phases' gelu cases)
    join the row's cases."""
    w = params["groups"]["b0"]["ffn"]["gate"][0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = fused_acam_cases(torch, timer, w, (8, 4, 512, 1024, 1, 16),
                             "silu", gen)
    top = cases[0]                          # paged decode: most launches
    cases += list(extra_cases)
    return {"name": "fused_crossbar_acam", "route": "cuda",
            "source": "src/repro_torch/csrc/dual_compute.cu",
            "replaces": "src/repro/kernels/dual_compute/kernel.py:80",
            **launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": f"one ACAM code of the case's table (silu "
                         f"{top['one_code']:.6g}) on at most "
                         f"{B_MAX_FLIP_FRACTION:g} of outputs",
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library": "torch.matmul(x, W_eff), the GEMM alone",
            "timing": timer.source, "cases": cases}


def causal_pairs(lq: int, lk: int) -> int:
    """(query, key) pairs a causal row set attends to, queries at the end
    of the KV axis."""
    return sum(max(0, min(lk, i + lk - lq + 1)) for i in range(lq))


def attention_inputs(torch, shape, dtype, seed):
    b, hq, hkv, lq, lk, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]


def dense_causal_attention(torch, q, k, v):
    """Causal GQA attention as one masked softmax in float32, queries at
    the end of the KV axis: kernel F's reference at a length where
    ``flash_attention_ref``'s blocks, halved until they divide it, shrink
    to a few rows (2 at 1110)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, lq, d) * d ** -0.5
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k.float())
    q_pos = torch.arange(lq, device=q.device) + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)
    s = s.masked_fill(k_pos[None, :] > q_pos[:, None], -torch.inf)
    return torch.einsum("bkgql,bkld->bkgqd", torch.softmax(s, -1),
                        v.float()).reshape(b, hq, lq, d)


def flash_case(torch, timer, shape, dtype, seed, dense=False,
               window=None) -> dict:
    """Kernel F on random (b, hq, lq, d) queries over (b, hkv, lk, d) keys
    and values in ``dtype``, held against the plain version (with
    ``dense``, against ``dense_causal_attention``) and timed beside it,
    SDPA and the bound.  With ``window`` (lq == lk <= window), held against
    the windowed ``blockwise_attention`` too: the route a windowed layer
    took before F had its head-dim-256 instance."""
    from repro_torch.kernels.flash_attention.ops import flash_attention, plan
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    t0 = time.perf_counter()
    b, hq, hkv, lq, lk, d = shape
    q, k, v = attention_inputs(torch, shape, dtype, seed)

    def plain():
        if dense:
            return dense_causal_attention(torch, q, k, v)
        return flash_attention_ref(q, k, v)

    out = flash_attention(q, k, v)
    ref = plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()) and out.dtype == dtype,
          "flash_attention: non-finite or not in q's dtype")
    err = (out.float() - ref).abs()
    # bf16 outputs round the same f32 result: one bf16 step allowed
    slack = 0.0 if dtype == torch.float32 else 2.0 ** -7
    check(bool((err <= F_TOL + slack * ref.abs()).all()),
          f"flash_attention {shape} {dtype}: max |kernel - plain| "
          f"{err.max().item()} over {F_TOL} (+ bf16 rounding)")

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)

    lib_err = (lib().float() - ref).abs().max().item()
    extra = {}
    if window is not None:
        from repro_torch.nn.attention import blockwise_attention
        check(lq == lk <= window, "flash_case: window route needs lq == lk "
              "<= window")
        bw = blockwise_attention(q, k, v, window=window).float()
        werr = (out.float() - bw).abs()
        check(bool((werr <= F_TOL + slack * bw.abs()).all()),
              f"flash_attention {shape} {dtype}: max |kernel - windowed "
              f"blockwise| {werr.max().item()} over {F_TOL}")
        extra["window_route_max_abs_err"] = werr.max().item()
        del bw, werr
    ms, call_ms = timer.ms(lambda: flash_attention(q, k, v), iters=10)
    plain_ms, _ = timer.ms(plain, iters=3)
    lib_ms, _ = timer.ms(lib, iters=10)
    esz = q.element_size()
    nbytes = esz * 2 * (q.numel() + k.numel())      # q, k, v, out
    flops = 4 * d * b * hq * causal_pairs(lq, lk)
    pl = plan(dtype, d)
    case = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "plain": ("dense_causal_attention" if dense
                      else "flash_attention_ref"),
            "ragged_keys": lk % pl.keys,
            "instance": pl.instance, "rows_per_block": pl.rows,
            "keys_per_tile": pl.keys,
            "smem": pl.smem, "max_abs_err": err.max().item(), **extra,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_max_abs_err": lib_err,
            **attn_bound(nbytes, flops,
                         2 if dtype == torch.bfloat16 else 3),
            **achieved(nbytes, flops, ms), "wall_s": time.perf_counter() - t0}
    print("[kernel F] " + json.dumps(case))
    return case


def flash_phase(torch, timer, launches: dict, extra_cases=()) -> dict:
    """Kernel F at the lockstep OFF prefill's shapes, (8, 16, 512, 128)
    queries over (8, 2, 512, 128) keys and values, and at (1, 16/2, 2048,
    128); f32 and bf16 inputs, each read in its own dtype.
    ``extra_cases`` (the Gemma3 phase's) join the row's cases."""
    cases = [flash_case(torch, timer, shape, dtype, SEED + 3)
             for shape in ((8, 16, 2, 512, 512, 128),
                           (1, 16, 2, 2048, 2048, 128))
             for dtype in (torch.float32, torch.bfloat16)]
    top = cases[0]
    cases += list(extra_cases)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
            **launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": f"{F_TOL} (bf16 outputs: plus one bf16 step)",
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library": "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True), same dtype",
            "scores": "split TF32 (mma.sync m16n8k8)",
            "timing": timer.source, "cases": cases}


def logdomain_case(torch, timer, shape, dtype, seed) -> dict:
    """Kernel C on random inputs of ``shape`` in ``dtype`` against the
    materialized NL-DPE attention on the same inputs, and its quantize
    launch, bit for bit ``log_quantize``; timed beside the plain version
    and the bound."""
    from repro_torch.core.logdomain import inv_sqrt, log_quantize
    from repro_torch.kernels.dual_compute.ops import (
        log_quantize_qkv, logdomain_flash_attention, logdomain_kernel,
        logdomain_plan)
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    t0 = time.perf_counter()
    b, hq, hkv, lq, lk, d = shape
    q, k, v = attention_inputs(torch, shape, dtype, seed)
    quantized = log_quantize_qkv(q, k, v)
    f32 = torch.float32
    plain_q = (log_quantize(q.to(f32) * inv_sqrt(d)),
               log_quantize(k.to(f32)), log_quantize(v.to(f32)))
    check(all(torch.equal(x, y) for x, y in zip(quantized, plain_q)),
          f"log_quantize_qkv {shape} {dtype}: not log_quantize's bits")
    del plain_q
    out = logdomain_flash_attention(q, k, v)
    ref = logdomain_flash_ref(q, k, v)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()) and out.dtype == dtype,
          "logdomain_flash: non-finite or not in q's dtype")
    err = (out.float() - ref).abs()
    # bf16 outputs round the same f32 result: one bf16 step allowed
    slack = 0.0 if dtype == torch.float32 else 2.0 ** -7
    check(bool((err <= C_TOL + slack * ref.abs()).all()),
          f"logdomain_flash {shape} {dtype}: max |kernel - plain| "
          f"{err.max().item()} over {C_TOL} (+ bf16 rounding)")
    err = err.max().item()
    del out, ref
    ms, call_ms = timer.ms(lambda: logdomain_flash_attention(q, k, v),
                           iters=10)
    quant_ms, _ = timer.ms(lambda: log_quantize_qkv(q, k, v), iters=10)
    kern_ms, _ = timer.ms(lambda: logdomain_kernel(*quantized, dtype),
                          iters=10)
    plain_ms, _ = timer.ms(lambda: logdomain_flash_ref(q, k, v), iters=3)
    esz = q.element_size()
    nbytes = esz * 2 * (q.numel() + k.numel())      # q, k, v, out
    flops = 4 * d * b * hq * causal_pairs(lq, lk)
    pl = logdomain_plan(lk, d)
    case = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "instance": pl.instance, "rows": pl.rows, "smem": pl.smem,
            "max_abs_err": err, "quantize_bitwise": True, "ms": ms,
            "call_ms": call_ms, "quantize_ms": quant_ms,
            "attention_kernel_ms": kern_ms, "plain_ms": plain_ms,
            "library_ms": None, **attn_bound(nbytes, flops, 3, 0.5),
            **achieved(nbytes, flops, ms), "wall_s": time.perf_counter() - t0}
    print("[kernel C] " + json.dumps(case))
    return case


def logdomain_phase(torch, timer, launches: dict, extra_cases=()) -> dict:
    """Kernel C at the lockstep FUSED prefill's shape (4, 16, 256, 128),
    with f32 inputs and with the bf16 activations that path gives it, at
    the OFF phase's (8, 16, 512, 128) and at (1, 16/2, 2048, 128) (the
    two-pass instance).  ``extra_cases`` (the Gemma3 phase's) join the
    row's cases."""
    cases = [logdomain_case(torch, timer, shape, dtype, SEED + 4)
             for shape, dtype in (
                 ((4, 16, 2, 256, 256, 128), torch.float32),
                 ((4, 16, 2, 256, 256, 128), torch.bfloat16),
                 ((8, 16, 2, 512, 512, 128), torch.float32),
                 ((1, 16, 2, 2048, 2048, 128), torch.float32))]
    top = cases[0]
    cases += list(extra_cases)
    return {"name": "logdomain_flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/logdomain_flash.cu",
            "replaces": "src/repro/kernels/dual_compute/kernel.py:176",
            **launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": f"{C_TOL:.6g} (bf16 outputs: plus one bf16 step)",
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "scores": "f32 FMA in d order (the plain version's bits); "
                      "P.V split TF32",
            "timing": timer.source, "cases": cases}


def gemm_err(torch, out, ref, a, b, slack_u: int = 8) -> float:
    """max |out - ref| / ((2 K + slack_u) u (|A| @ |B|)) over the outputs:
    at most 1 when two float32 GEMMs differ only by their sum order (the
    worst-case rounding of two length-K dot products is 2 K u of
    sum |a||b|), with ``slack_u`` u per product for operands that round
    apart: 8 for expf against exp on both of G's operands; 40 against
    ``nldpe_matmul`` fused, whose decode rounds ``code * step + log_lo``
    twice where G rounds it once — one ulp of an argument up to 9.2 in
    magnitude is 16 u of its exp."""
    k = a.shape[-1]
    scale = (a.abs() @ b.abs()) * ((2 * k + slack_u) * U32)
    return ((out - ref).abs() / scale.clamp(min=1e-30)).max().item()


def library_phase(torch, params) -> dict:
    """The ``[library]`` path at full width, kernels D, E and G through
    the public entry points, with every count set to 0 before it and read
    after it: the layer-0 MLP gate weight (the one kernel B's phase takes)
    programmed with A-SL programming noise, then E -> D at M = 8 (a paged
    decode tick) and M = 512 (a prefill chunk), G at ``G_SHAPES``, and the
    quickstart.  Returns the launches and the tensors the kernel phases
    time."""
    from repro_torch import quickstart
    from repro_torch.core.acam import get_table
    from repro_torch.core.crossbar import program_linear
    from repro_torch.kernels import (acam_apply, crossbar_matmul,
                                     nldpe_matmul_int8)
    from repro_torch.launch import prng
    w = params["groups"]["b0"]["ffn"]["gate"][0]
    k, n = w.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    xs = {m: torch.randn((m, k), generator=gen, device="cuda")
          for m in (8, 512)}
    g_in = {shape: log_grid_operands(torch, shape, gen) for shape in G_SHAPES}
    table = get_table("silu", 8)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan, eps = program_linear(w, rng=prng.prng_key(1))
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    y, z, read_s = {}, {}, {}
    for m, x in xs.items():
        t0 = time.perf_counter()
        y[m] = crossbar_matmul(x, plan, rng=prng.prng_key(10 + m))
        z[m] = acam_apply(y[m], table)
        torch.cuda.synchronize()
        read_s[m] = time.perf_counter() - t0
    c = {shape: nldpe_matmul_int8(a, b) for shape, (a, b) in g_in.items()}
    qs = quickstart.main()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters()}
    # quickstart's D: 1 GELU call and the hard evaluations of its NAF
    # section (8 draws before, 1 clean, 8 an epoch, 8 after)
    naf_evals = 8 * (quickstart.NAF_EPOCHS + 2) + 1
    want = {"crossbar_vmm": 3, "acam_apply": 3 + naf_evals,
            "nldpe_qmatmul": 4}
    for name, count in want.items():
        check(launches[name] == count, f"library: {name} launched "
              f"{launches[name]} times, expected {count} (2 + 1 quickstart "
              f"for E, 2 + 1 + {naf_evals} for D, 3 + 1 for G)")
    check(bool(torch.equal(qs["gelu"]["kernel"], qs["gelu"]["interval"])),
          "library: quickstart's kernel-D GELU differs from its interval "
          "match")
    for m in xs:
        check(bool(torch.isfinite(z[m]).all()) and z[m].shape == (m, n),
              f"library: E->D output at M={m}")
    for shape, out in c.items():
        check(bool(torch.isfinite(out).all()) and tuple(out.shape)
              == (shape[0], shape[2]), f"library: G output at {shape}")
    out = {"w": [k, n], "program_noise_s": program_s,
           "max_programming_residual": eps.max().item(),
           "read_noise_e_d_s": read_s, "launches": launches,
           "quickstart": {k: v for k, v in qs.items() if k != "gelu"}}
    print("[library] " + json.dumps(out))
    return {"plan": plan, "x": xs, "y": y, "z": z, "table": table,
            "g_in": g_in, "c": c, "launches": launches, **out}


def log_grid_operands(torch, shape, gen):
    """DMMul operands (M, K) and (K, N) drawn into the log grid's range:
    magnitudes log-uniform over [1e-4, 16] (every code), random signs, and
    1% exact zeros (dead values, sign 0)."""
    from repro_torch.core.logdomain import DEFAULT_CFG
    spec = DEFAULT_CFG.mag_spec
    out = []
    for rows, cols in ((shape[0], shape[1]), (shape[1], shape[2])):
        u = torch.rand((rows, cols), generator=gen, device="cuda")
        mag = torch.exp(spec.log_lo + u * (spec.log_hi - spec.log_lo))
        sign = torch.where(torch.rand((rows, cols), generator=gen,
                                      device="cuda") < 0.5, -1.0, 1.0)
        keep = torch.rand((rows, cols), generator=gen, device="cuda") >= 0.01
        out.append(mag * sign * keep)
    return out


def library_checks(torch, lib: dict) -> dict:
    """D o E against kernel B on the same read-noise cells and the same
    float32 inv: bitwise expected (shared main loop and epilogue),
    otherwise one ACAM code on at most B_MAX_FLIP_FRACTION of outputs; G
    against ``nldpe_matmul(mode="fused")``."""
    from repro_torch.core.acam import table_thresholds
    from repro_torch.core.logdomain import nldpe_matmul
    from repro_torch.kernels.crossbar_vmm.ops import inv_g_ratio, read_cells
    from repro_torch.kernels.dual_compute.ops import fused_crossbar_acam
    from repro_torch.launch import prng
    table, plan = lib["table"], lib["plan"]
    lo, hi = table_thresholds(table, "cuda")
    step = float(table.out_spec.step)
    inv = torch.tensor([inv_g_ratio(plan)], device="cuda")
    res = {}
    for m, x in lib["x"].items():
        cells = read_cells(plan, prng.prng_key(10 + m))
        b = fused_crossbar_acam(x, *cells, inv, lo, hi,
                                out_lo=float(table.out_spec.lo),
                                out_step=step)
        torch.cuda.synchronize()
        diff = (b - lib["z"][m]).abs()
        n_diff = int((diff > 0).sum().item())
        check(diff.max().item() <= step * 1.0001
              and n_diff <= B_MAX_FLIP_FRACTION * diff.numel(),
              f"library: D o E vs B at M={m}: {n_diff} outputs differ, max "
              f"{diff.max().item()}")
        res[f"d_e_vs_b_m{m}_outputs_differing"] = n_diff
    for shape, (a, b) in lib["g_in"].items():
        ref = nldpe_matmul(a, b, mode="fused")
        torch.cuda.synchronize()
        r = gemm_err(torch, lib["c"][shape], ref, a, b, slack_u=40)
        check(r <= 1.0, f"library: G vs nldpe_matmul fused at {shape}: "
              f"error {r:.3g} of the sum-order bound")
        res[f"g_vs_fused_{'x'.join(map(str, shape))}_err_of_bound"] = r
    print("[library checks] " + json.dumps(res))
    return res


def acam_phase(torch, timer, lib: dict) -> dict:
    """Kernel D on the library path's pre-activations, (8, 11008) and
    (512, 11008), against its plain version (bitwise: the same compares
    and roundings) and beside the piecewise fast path."""
    from repro_torch.core.acam import acam_activation, table_thresholds
    from repro_torch.kernels.acam_activation.ops import acam_apply
    from repro_torch.kernels.acam_activation.ref import acam_activation_ref
    table = lib["table"]
    lo, hi = table_thresholds(table, "cuda")
    kw = dict(out_lo=float(table.out_spec.lo),
              out_step=float(table.out_spec.step))
    cases = []
    for m in (8, 512):
        y = lib["y"][m]
        out = acam_apply(y, table)
        ref = acam_activation_ref(y, lo, hi, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(bool(torch.equal(out, ref)), f"acam_apply {tuple(y.shape)}: "
              f"kernel differs from plain (max {err})")
        ms, call_ms = timer.ms(lambda: acam_apply(y, table), iters=20)
        plain_ms, _ = timer.ms(lambda: acam_activation_ref(y, lo, hi, **kw),
                               iters=3)
        lib_ms, _ = timer.ms(lambda: acam_activation(y, "silu"), iters=20)
        # 4 bytes in and 4 out per element, the table once; the compares
        # are not float32 FLOPs
        nbytes = 8 * y.numel() + 4 * 2 * lo.numel()
        bms, by = bound(nbytes, 0)
        case = {"shape": list(y.shape), "max_abs_err": err, "ms": ms,
                "call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                **achieved(nbytes, 0, ms)}
        print("[kernel D] " + json.dumps(case))
        cases.append(case)
    top = cases[1]
    return {"name": "acam_apply", "route": "cuda",
            "source": "src/repro_torch/csrc/acam_activation.cu",
            "replaces": "src/repro/kernels/acam_activation/kernel.py:57",
            "launches": lib["launches"]["acam_apply"],
            "launches_by": "[library] phase (E->D passes and the quickstart "
                           "with its NAF section); [naf dt] and [naf "
                           "pipeline] add theirs after they run",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": "bitwise", "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "library": "none computes the interval match; fast path "
                       "core.acam.acam_activation (searchsorted) in the "
                       "cases' library_ms",
            "timing": timer.source, "cases": cases}


def crossbar_phase(torch, timer, lib: dict) -> dict:
    """Kernel E at M = 8 and 512, K = 2048, N = 11008, on the library
    plan's read-noise cells, against its plain version (cuBLAS)."""
    from repro_torch.kernels.crossbar_vmm.ops import (crossbar_vmm,
                                                      inv_g_ratio,
                                                      read_cells,
                                                      tile_variant)
    from repro_torch.kernels.crossbar_vmm.ref import crossbar_vmm_ref
    from repro_torch.kernels.dual_compute.ref import effective_weight
    from repro_torch.launch import prng
    plan = lib["plan"]
    inv = inv_g_ratio(plan)
    cases = []
    for m, x in lib["x"].items():
        cells = read_cells(plan, prng.prng_key(10 + m))
        w_eff = effective_weight(*cells, inv)
        k, n = w_eff.shape
        out = crossbar_vmm(x, *cells, inv)
        ref = crossbar_vmm_ref(x, *cells, inv)
        torch.cuda.synchronize()
        check(torch.equal(out, lib["y"][m]), f"crossbar_vmm M={m}: not the "
              f"library path's output")
        r = gemm_err(torch, out, ref, x, w_eff)
        check(r <= 1.0, f"crossbar_vmm M={m}: error {r:.3g} of the "
              f"sum-order bound")
        err = (out - ref).abs().max().item()
        ms, call_ms = timer.ms(lambda: crossbar_vmm(x, *cells, inv), iters=10)
        plain_ms, _ = timer.ms(lambda: crossbar_vmm_ref(x, *cells, inv),
                               iters=3)
        lib_ms, _ = timer.ms(lambda: torch.matmul(x, w_eff), iters=10)
        nbytes = 4 * (m * k + 4 * k * n + m * n)
        flops = 2 * m * k * n + 5 * k * n
        bms, by = bound(nbytes, flops)
        case = {"m": m, "k": k, "n": n, "tile": tile_variant(m, n),
                "max_abs_err": err,
                "err_of_bound": r, "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bms, "bound_by": by,
                **achieved(nbytes, flops, ms)}
        print("[kernel E] " + json.dumps(case))
        cases.append(case)
    top = cases[0]
    return {"name": "crossbar_vmm", "route": "cuda",
            "source": "src/repro_torch/csrc/crossbar_vmm.cu",
            "replaces": "src/repro/kernels/crossbar_vmm/kernel.py:44",
            "launches": lib["launches"]["crossbar_vmm"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": "(2K + 8) u (|x| @ |W_eff|) per output",
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library": "torch.matmul(x, W_eff), the GEMM alone",
            "timing": timer.source, "cases": cases}


def qmatmul_case(torch, timer, a, b, *, check_against=None) -> dict:
    """Kernel G on one pair of DMMul operands: held against its plain
    version ((2 K + 8) u) and ``nldpe_matmul`` fused ((2 K + 40) u), and
    timed beside the plain version, ``torch.matmul`` of the dequantized
    operands and the bound.  ``check_against``: an output the path gave
    on these operands, which must be G's bit for bit."""
    from repro_torch.core.logdomain import DEFAULT_CFG, nldpe_matmul
    from repro_torch.kernels.nldpe_qmatmul.ops import (encode_int8,
                                                       nldpe_qmatmul,
                                                       tile_variant)
    from repro_torch.kernels.nldpe_qmatmul.ref import (dequant_ref,
                                                       nldpe_qmatmul_ref)
    spec = DEFAULT_CFG.mag_spec
    m, k = a.shape
    n = b.shape[1]
    codes = (*encode_int8(a), *encode_int8(b), spec.step, spec.log_lo)
    out = nldpe_qmatmul(*codes)
    ref = nldpe_qmatmul_ref(*codes)
    torch.cuda.synchronize()
    if check_against is not None:
        check(torch.equal(out, check_against), f"nldpe_qmatmul {(m, k, n)}: "
              f"not the path's output")
    da, db = dequant_ref(*codes[:2], *codes[4:]), \
        dequant_ref(*codes[2:4], *codes[4:])
    r = gemm_err(torch, out, ref, da, db)
    check(r <= 1.0, f"nldpe_qmatmul {(m, k, n)}: error {r:.3g} of the "
          f"sum-order bound")
    r_fused = gemm_err(torch, out, nldpe_matmul(a, b, mode="fused"), da, db,
                       slack_u=40)
    check(r_fused <= 1.0, f"nldpe_qmatmul {(m, k, n)}: error {r_fused:.3g} "
          f"of the bound against nldpe_matmul fused")
    err = (out - ref).abs().max().item()
    ms, call_ms = timer.ms(lambda: nldpe_qmatmul(*codes), iters=10)
    plain_ms, _ = timer.ms(lambda: nldpe_qmatmul_ref(*codes), iters=3)
    lib_ms, _ = timer.ms(lambda: torch.matmul(da, db), iters=10)
    nbytes, flops = 2 * (m * k + k * n) + 4 * m * n, 2 * m * k * n
    bms, by = bound(nbytes, flops)
    return {"shape": [m, k, n], "tile": tile_variant(m, n),
            "max_abs_err": err, "err_of_bound": r,
            "err_of_fused_bound": r_fused, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, **achieved(nbytes, flops, ms)}


def qmatmul_phase(torch, timer, lib: dict, cnn_res: dict) -> dict:
    """Kernel G at every conv shape of one ``ON`` CNN forward (its main
    path, ``[cnn]``: the operands that forward gave it) and at the
    library path's three DMMul shapes; the row's top numbers are the
    stage-0 conv's (M 32768, K 144, N 16), and G's device ms per ``ON``
    forward is the sum over the forward's 15 calls."""
    cases, by_shape = [], {}
    for a, b, out in cnn_res["g_calls"]:
        shape = (a.shape[0], a.shape[1], b.shape[1])
        if shape not in by_shape:
            by_shape[shape] = {"path": "cnn", "calls_per_on_forward": 0,
                               **qmatmul_case(torch, timer, a, b,
                                              check_against=out)}
            cases.append(by_shape[shape])
        by_shape[shape]["calls_per_on_forward"] += 1
    for case in cases:
        print("[kernel G] " + json.dumps(case))
    for shape, (a, b) in lib["g_in"].items():
        case = {"path": "library",
                **qmatmul_case(torch, timer, a, b,
                               check_against=lib["c"][shape])}
        print("[kernel G] " + json.dumps(case))
        cases.append(case)
    top = by_shape[CNN_G_TOP]
    per_forward = sum(c["ms"] * c["calls_per_on_forward"]
                      for c in by_shape.values())
    print(f"[kernel G] {len(cnn_res['g_calls'])} calls per ON CNN forward: "
          f"{per_forward:.4f} device ms (sum of the calls' event times)")
    return {"name": "nldpe_qmatmul", "route": "cuda",
            "source": "src/repro_torch/csrc/nldpe_qmatmul.cu",
            "replaces": "src/repro/kernels/nldpe_qmatmul/kernel.py:50",
            "launches": cnn_res["kernel_g_launches"],
            "launches_per_on_forward": len(cnn_res["g_calls"]),
            "launches_library": lib["launches"]["nldpe_qmatmul"],
            "device_ms_per_on_forward": per_forward,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": "(2K + 8) u (|A^| @ |B^|) per output; against "
                         "nldpe_matmul fused (2K + 40) u",
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library": "torch.matmul of the dequantized f32 operands",
            "timing": timer.source, "cases": cases}


def cnn_phase(torch) -> dict:
    """``[cnn]``: ``repro_torch.train_cnn_nldpe.main`` at full width,
    ``CNNConfig()`` (stages 16/32/64, 2 blocks, 32 x 32, 10 classes), the
    example's data at batch ``CNN_BATCH``: 120 AdamW steps under ``OFF``,
    accuracies in float32, ``ON`` (every conv through kernel G) and under
    6x crossbar noise, then 50 crossbar-NAF steps.  Every count is set to
    0 just before ``main`` and read just after: G must launch 15 times per
    ``ON`` forward; the first ``ON`` forward's 15 calls are kept (operands
    and outputs) for the kernel phase.  Checks: the card's ``OFF`` logits
    of the first batch at the initial weights within ``CNN_OFF_TOL`` of
    the CPU's (both drawn on the CPU generator; cuDNN with TF32 off);
    losses finite, the last below 0.8 x the first; NAF never hurts
    (recovered >= degraded - 0.02)."""
    from repro_torch import train_cnn_nldpe
    from repro_torch.core.drift import flatten
    from repro_torch.core.engine import ON
    from repro_torch.data.images import ImageDataConfig, make_batch_fn
    from repro_torch.kernels.nldpe_qmatmul import ops as g_ops
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig()
    data = ImageDataConfig(num_classes=cfg.num_classes, batch=CNN_BATCH,
                           noise=0.9)
    first = make_batch_fn(data, device="cpu")(0)["images"]
    logits = {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            p = cnn.init_params(cfg, device=dev)
            logits[dev] = cnn.forward(p, first.to(dev), cfg).cpu()
    off_err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    check(off_err <= CNN_OFF_TOL, f"cnn: card vs CPU OFF logits {off_err} > "
          f"{CNN_OFF_TOL}")
    calls = []
    launch = g_ops.nldpe_matmul_int8

    def kept(a, b, ld_cfg):
        out = launch(a, b, ld_cfg)
        if len(calls) < 15:
            calls.append((a.clone(), b.clone(), out.clone()))
        return out

    g_ops.nldpe_matmul_int8 = kept
    try:
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = train_cnn_nldpe.main(cfg, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters()}
    finally:
        g_ops.nldpe_matmul_int8 = launch
    peak = torch.cuda.max_memory_allocated() - base
    on_forwards = train_cnn_nldpe.EVAL_DRAWS
    want = {name: 0 for name in launches}
    want["nldpe_qmatmul"] = 15 * on_forwards
    check(launches == want, f"cnn: launches {launches}, expected {want} (15 "
          f"G launches per ON forward, {on_forwards} ON forwards)")
    check(len(calls) == 15, f"cnn: {len(calls)} G calls kept")
    losses = res["losses"]
    check(bool(np.isfinite(losses).all()), "cnn: non-finite loss")
    check(losses[-1] < 0.8 * losses[0], f"cnn: loss did not fall: "
          f"{losses[0]} -> {losses[-1]}")
    check(res["naf_acc"] >= res["noisy_acc"] - 0.02, f"cnn: NAF hurt: "
          f"{res['noisy_acc']} -> {res['naf_acc']}")
    # one ON forward timed alone (host clock behind syncs)
    p = cnn.init_params(cfg, device="cuda")
    x = first.cuda()
    with torch.no_grad():
        cnn.forward(p, x, cfg, nldpe=ON)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cnn.forward(p, x, cfg, nldpe=ON)
        torch.cuda.synchronize()
        on_s = time.perf_counter() - t0
    info = {"model": cfg.name, "stages": list(cfg.stage_channels),
            "blocks_per_stage": cfg.blocks_per_stage, "batch": CNN_BATCH,
            "img_size": cfg.img_size, "classes": cfg.num_classes,
            "parameters": sum(t.numel() for _, t in flatten(p)),
            "first_loss": losses[0], "last_loss": losses[-1],
            "losses_every_30": losses[::30],
            **{k: v for k, v in res.items() if k != "losses"},
            "off_logits_card_vs_cpu": off_err, "off_tolerance": CNN_OFF_TOL,
            "kernel_g_launches": launches["nldpe_qmatmul"],
            "kernel_g_launches_per_on_forward":
                launches["nldpe_qmatmul"] / on_forwards,
            "on_forward_wall_s": on_s, "seconds": wall,
            "peak_gb_above_resident": peak / 1e9}
    print("[cnn] " + json.dumps(info))
    return {**info, "g_calls": calls}


def train_ckpt_phase(torch) -> dict:
    """``[train ckpt]``: the train CLI on the card at its reduced default
    arch, ``--steps 10 --batch 2 --seq 16 --ckpt-every 5`` under a
    temporary ``--ckpt-dir``: killed at step 7 (``--fail-at-step``, must
    raise), resumed from the step-5 checkpoint, then uninterrupted; the
    resumed losses must be the uninterrupted run's within rtol 1e-4 (it
    reports whether they are bitwise).  Then a blocking ``save`` and a
    ``restore`` of the run's step-10 ``{"params", "opt"}`` onto the card,
    timed behind syncs; the restored tensors must equal the saved ones bit
    for bit."""
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.drift import flatten
    from repro_torch.launch.train import run
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    argv = ["--steps", "10", "--batch", "2", "--seq", "16", "--ckpt-every",
            "5"]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ck = str(Path(tmp) / "ck")
        t0 = time.perf_counter()
        try:
            run(argv + ["--ckpt-dir", ck, "--fail-at-step", "7"])
            fail("train ckpt: --fail-at-step 7 did not raise")
        except RuntimeError as exc:
            check("injected failure at step 7" in str(exc),
                  f"train ckpt: unexpected failure {exc!r}")
        check(CheckpointManager(ck).latest_step() == 5,
              "train ckpt: no step-5 checkpoint after the failure")
        resumed = run(argv + ["--ckpt-dir", ck])
        clean = run(argv)
        runs_s = time.perf_counter() - t0
        check(len(resumed) == 5 and bool(np.isfinite(resumed).all()),
              f"train ckpt: resumed losses {resumed}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, clean[5:]))
        check(rel <= 1e-4, f"train ckpt: resumed losses {resumed} vs "
              f"uninterrupted {clean[5:]}: relative difference {rel}")
        cfg = get_config("qwen2_7b", reduced=True)
        params = lm.init_params(cfg, device="cuda")
        template = {"params": params, "opt": adamw.init(params)}
        state, step = CheckpointManager(ck).restore_latest(template)
        check(step == 10, f"train ckpt: latest step {step}")
        timed = CheckpointManager(str(Path(tmp) / "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.save(state, 10)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = timed.restore(template, 10)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved = [t for _, t in flatten(state)]
        got = [t for _, t in flatten(back)]
        check(len(saved) == len(got) and all(
            g.device.type == "cuda" and g.dtype == s.dtype
            and torch.equal(g, s) for s, g in zip(saved, got)),
            "train ckpt: restored tensors differ from the saved ones")
        nbytes = sum(t.numel() * t.element_size() for t in saved)
    info = {"arch": cfg.name, "argv": argv, "resumed_losses": resumed,
            "uninterrupted_losses": clean[5:],
            "max_relative_difference": rel,
            "bitwise": resumed == clean[5:], "runs_s": runs_s,
            "state_leaves": len(saved), "state_bytes": nbytes,
            "save_s": save_s, "restore_s": restore_s,
            "restored_bitwise": True}
    print("[train ckpt] " + json.dumps(info))
    return info


def naf_dt_phase(torch, timer) -> dict:
    """``[naf dt]``: NAF step 4 for ``silu`` (Qwen2.5-3B's activation) at
    ``finetune_table``'s defaults (10 epochs, 5000 samples, batch 512, 4
    noise draws), from ``corrupt_table(silu, key 11, DEFAULT.rescale(6))``
    under ``DEFAULT.rescale(2)``, as ``examples/naf_pipeline.py`` sets it
    up, with every count set to 0 before it.  Every hard evaluation (8
    draws before, 1 clean, 8 an epoch, 8 after) runs through kernel D: its
    launches must be those 97, the table must recover by half
    (``mse_after < 0.5 * mse_before``, the bound of tests/test_naf.py),
    and kernel D on one evaluation's noisy thresholds must equal its plain
    version bit for bit; prints the MSEs, the history and D's device ms
    per evaluation."""
    from repro_torch.core import dt, noise
    from repro_torch.core.differentiable import (DiffACAMConfig,
                                                 _thresholds_through_cells)
    from repro_torch.core.naf import corrupt_table, finetune_table
    from repro_torch.kernels.acam_activation.ops import (acam_apply,
                                                         acam_apply_grid)
    from repro_torch.kernels.acam_activation.ref import acam_activation_ref
    from repro_torch.launch import prng
    table = dt.build_table("silu")
    model = noise.DEFAULT.rescale(2.0)
    bad = corrupt_table(table, prng.prng_key(11), noise.DEFAULT.rescale(6.0),
                        device="cuda")
    epochs = 10
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = finetune_table(bad, rng=prng.prng_key(1), model=model,
                         epochs=epochs, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = acam_apply.launches
    want = 8 * (epochs + 2) + 1
    check(launches == want, f"naf dt: kernel D launched {launches} times, "
          f"expected {want} (every hard evaluation)")
    check(np.isfinite([res.mse_before, res.mse_after, res.mse_clean]).all(),
          "naf dt: non-finite MSE")
    check(res.mse_after < 0.5 * res.mse_before, f"naf dt: no recovery: "
          f"{res.mse_before} -> {res.mse_after}")
    # one evaluation's operands: 2048 points on the fine-tuned table's
    # thresholds through noisy cells
    cfg = DiffACAMConfig(bits=table.bits, th_lo=-8.0, th_hi=8.0)
    k1, k2 = prng.split(prng.prng_key(5).cuda())
    with torch.no_grad():
        wl, wh = (_thresholds_through_cells(
            k, torch.from_numpy(t).cuda(), cfg, model).contiguous()
            for k, t in ((k1, res.table.lo), (k2, res.table.hi)))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -8, 8, 2048).astype(np.float32)).cuda()
    grid = (float(table.out_spec.lo), float(table.out_spec.step))
    out = acam_apply_grid(x, wl, wh, *grid)
    ref = acam_activation_ref(x, wl, wh, *grid)
    check(bool(torch.equal(out, ref)), "naf dt: kernel D differs from its "
          "plain version on noisy NAF thresholds")
    ms, call_ms = timer.ms(lambda: acam_apply_grid(x, wl, wh, *grid),
                           iters=20)
    plain_ms, _ = timer.ms(lambda: acam_activation_ref(x, wl, wh, *grid),
                           iters=5)
    info = {"function": "silu", "epochs": epochs, "samples": 5000,
            "batch": 512, "noise_draws": 4, "mse_clean": res.mse_clean,
            "mse_before": res.mse_before, "mse_after": res.mse_after,
            "recovery": res.mse_after / res.mse_before,
            "history": res.history, "seconds": wall,
            "kernel_d_launches": launches,
            "kernel_d_ms_per_evaluation": ms,
            "kernel_d_call_ms_per_evaluation": call_ms,
            "plain_ms_per_evaluation": plain_ms,
            "kernel_d_equals_plain": True}
    print("[naf dt] " + json.dumps(info))
    return info


def naf_pipeline_phase(torch) -> dict:
    """``[naf pipeline]``: ``repro_torch.naf_pipeline.main()`` on the card
    (reduced MiniCPM-2B: pretraining, crossbar NAF, the DT-ACAM model,
    per-DT NAF of ``silu``), every count set to 0 before it: finite losses,
    step 4 recovers, and its 57 hard evaluations run through kernel D."""
    from repro_torch import naf_pipeline
    from repro_torch.kernels.acam_activation.ops import acam_apply
    zero_counts()
    t0 = time.perf_counter()
    out = naf_pipeline.main()
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["kernel_d_launches"] = acam_apply.launches
    check(all(np.isfinite(v) for v in out.values()), f"naf pipeline: "
          f"non-finite result {out}")
    check(out["kernel_d_launches"] == 8 * (5 + 2) + 1, f"naf pipeline: "
          f"kernel D launched {out['kernel_d_launches']} times, expected 57")
    check(out["step4_mse_after"] < out["step4_mse_before"],
          "naf pipeline: step 4 did not recover")
    print("[naf pipeline] " + json.dumps(out))
    return out


def train_steps(torch, cfg, params, shape: tuple, kinds: tuple,
                label: str, seed: int) -> dict:
    """Train steps of ``cfg`` on the float32 masters ``params`` (updated in
    place) on a batch of ``shape`` = (batch, seq) seeded uniform tokens:
    ``kinds`` names each step, "adamw" (a plain AdamW step) or "naf" (a
    crossbar-NAF step, lambda 1e-5), lr 1e-4.  Prints each step's loss,
    grad norm, the seconds of its noise pass, forward plus backward and
    update (behind syncs) and its wall seconds, then the parameters and
    the peak memory, which must stay under the card's 80 GB; every loss
    and grad norm must be finite."""
    from repro_torch.launch.train import build_train_step
    from repro_torch.optim import adamw
    b, s = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    del toks
    opt_cfg = adamw.AdamWConfig(lr=1e-4)
    fns = {"adamw": build_train_step(cfg, opt_cfg, timed=True),
           "naf": build_train_step(cfg, opt_cfg, naf=True,
                                   naf_lambda1=1e-5, naf_lambda2=1e-5,
                                   timed=True)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw.init(params)
    steps = []
    zero_counts()
    for kind in kinds:
        t0 = time.perf_counter()
        params, opt, m = fns[kind](params, opt, batch)
        torch.cuda.synchronize()
        steps.append({"kind": kind, "loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item(),
                      "seconds": m["seconds"],
                      "wall_s": time.perf_counter() - t0})
        check(np.isfinite(steps[-1]["loss"])
              and np.isfinite(steps[-1]["grad_norm"]), f"{label}: {kind} "
              f"step loss or grad norm is not finite")
        print(f"[{label} step] " + json.dumps(steps[-1]))
    peak = torch.cuda.max_memory_allocated()
    check(peak < 80e9, f"{label}: peak memory {peak / 1e9:.2f} GB")
    info = {"model": cfg.name, "layers": cfg.n_layers,
            "layer_pattern": list(cfg.layer_pattern),
            "parameters": cfg.param_count(), "batch": [b, s],
            "compute_dtype": str(cfg.activation_dtype),
            "scan_remat": cfg.scan_remat, "steps": steps,
            "peak_gb": peak / 1e9,
            "kernel_launches": {fn.__name__: fn.launches
                                for fn in counters() if fn.launches}}
    if cfg.moe is not None:
        info["capacity_factor"] = cfg.moe.capacity_factor
    print(f"[{label}] " + json.dumps(info))
    del opt, batch
    torch.cuda.empty_cache()
    return info


def train_phase(torch, cfg, params) -> dict:
    """``[train]``: full-width Qwen2.5-3B (cut to ``CUT_LAYERS`` layers)
    training steps on its float32 masters, bf16 compute, each layer
    recomputed in the backward pass: one AdamW step, then two crossbar-NAF
    steps on a batch of 8 x 64 (``train_steps``)."""
    return train_steps(torch, cfg, params, (8, 64), ("adamw", "naf", "naf"),
                       "train", SEED + 21)


def family_train(torch, cfg, params, shape: tuple, label: str) -> dict:
    """A family phase's ``[<label> train]``: two plain AdamW steps of the
    train cut ``cfg`` on ``params`` (views of the phase's own float32
    masters), bf16 compute, layers recomputed in the backward pass, at
    full width (``train_steps``)."""
    return train_steps(torch, cfg, params, shape, ("adamw", "adamw"),
                       f"{label} train", SEED + 41)


def cut_depth(cfg, params, n_layers: int):
    """``cfg`` cut to its first ``n_layers`` layers, a whole number of its
    layer pattern's groups (the tail dropped), and ``params`` with every
    stacked block leaf viewed to those groups' rows and no ``"tail"``: no
    copy, so an in-place update writes the float32 masters."""
    groups, rest = divmod(n_layers, len(cfg.layer_pattern))
    check(rest == 0 and 0 < n_layers <= cfg.n_layers, f"cut_depth: "
          f"{n_layers} layers are not whole groups of {cfg.name}'s "
          f"{cfg.n_layers}-layer {cfg.layer_pattern} stack")

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:groups]

    out = {k: v for k, v in params.items() if k != "tail"}
    out["groups"] = cut(params["groups"])
    return dataclasses.replace(cfg, n_layers=n_layers), out


def cut_config(name: str, n_layers: int):
    """The full-width config ``name`` cut to ``n_layers`` layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), n_layers=n_layers)


def gemma3_trace(cfg, n: int, max_new: int):
    """``n`` requests of 1100-1400 random tokens (past the 1024 window),
    two ticks apart."""
    from repro_torch.launch.engine import Request
    rng = np.random.default_rng(SEED + 23)
    return [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(1100, 1401)))),
        max_new_tokens=max_new, arrival=2 * i) for i in range(n)]


def greedy_alone(torch, cfg, sp, prompt, gen_len: int, nldpe) -> tuple:
    """One request alone through the lockstep path (whole-prompt prefill,
    then the per-token loop): its greedy tokens and the top-2 logit margin
    at each."""
    from repro_torch.launch.serve import build_prefill_step
    from repro_torch.models import lm
    cache = lm.init_model_cache(cfg, 1, len(prompt) + gen_len,
                                device="cuda")
    logits, cache = build_prefill_step(cfg, nldpe=nldpe)(
        sp, cache, torch.tensor([prompt], dtype=torch.int32, device="cuda"))
    toks, margins = [], []
    for i in range(gen_len):
        top = torch.topk(logits[0], 2)
        toks.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1]))
        if i < gen_len - 1:
            logits = lm.decode_step(
                sp, cfg, torch.tensor([toks[-1]], dtype=torch.int32,
                                      device="cuda"),
                len(prompt) + i, cache, nldpe=nldpe)
    return toks, margins


def recording_routes(calls: list):
    """While active, append each MoE layer's routed experts
    (``nn.moe.route``'s ``expert_idx``, as (tokens, k)) to ``calls``."""
    import contextlib

    import repro_torch.nn.moe as moe
    plain = moe.route

    def route(probs, s, cap):
        r = plain(probs, s, cap)
        calls.append(r["expert_idx"].reshape(-1, s.top_k))
        return r

    @contextlib.contextmanager
    def active():
        moe.route = route
        try:
            yield
        finally:
            moe.route = plain
    return active()


def route_flips(routes: tuple) -> dict:
    """Routing flips between two prefills of one prompt: ``routes`` holds
    each route's per-layer (tokens, k) experts.  A token-layer flips where
    the top-k sets differ; ``one_expert``: one expert swapped;
    ``last_place``: the first route's k-th choice swapped, the others kept
    (a near-tie at the edge of the top k)."""
    a_calls, b_calls = routes
    flips = one = last = total = 0
    for a, b in zip(a_calls, b_calls):
        member = (a[:, :, None] == b[:, None, :]).any(-1)       # (n, k)
        missing = a.shape[1] - member.sum(-1)
        flips += int((missing > 0).sum())
        one += int((missing == 1).sum())
        last += int(((missing == 1) & ~member[:, -1]).sum())
        total += a.shape[0]
    return {"token_layers": total, "flips": flips, "one_expert": one,
            "last_place": last}


def window_route_deviation(torch, cfg, sp, prompt, chunk: int,
                           page_size: int | None = None,
                           routes: list | None = None) -> float:
    """D: the largest |logit| difference between the two routes a request
    takes — the lockstep prefill (kernel F on the global layer, the band
    on the local ones, rings of ``window`` lines) and the engine's chunked
    prefill (``chunk`` positions a call over rings of ``window + chunk -
    1`` lines; with ``page_size``, over a paged cache through kernel A) —
    at the prompt's last token and one decode step after it, on the same
    weights.  With ``routes`` (MoE), appends the two prefills' per-layer
    routed experts (lockstep, chunked) for ``route_flips``."""
    import contextlib

    from repro_torch.launch.serve import build_prefill_step
    from repro_torch.models import lm
    n = len(prompt)
    calls = ([], [])

    def record(i):
        return (contextlib.nullcontext() if routes is None
                else recording_routes(calls[i]))
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    lock = lm.init_model_cache(cfg, 1, n + 1, device="cuda")
    with record(0):
        a0, lock = build_prefill_step(cfg)(sp, lock, toks)
    nxt = torch.argmax(a0, -1).to(torch.int32)
    a1 = lm.decode_step(sp, cfg, nxt, n, lock)
    if page_size:
        nb = -(-(n + 1) // page_size)
        slot = lm.init_model_cache(cfg, 1, n + 1, paged=(nb, page_size),
                                   device="cuda")
        slot["bt"][0] = torch.arange(nb, dtype=torch.int32, device="cuda")
    else:
        slot = lm.init_model_cache(cfg, 1, n + 1, slotted=True,
                                   ring_slack=chunk - 1, device="cuda")
    with record(1):
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            pos = torch.arange(c0, c1, dtype=torch.int32,
                               device="cuda")[None]
            b0 = lm.forward(sp, toks[:, c0:c1], cfg, mode="chunk",
                            cache=slot, positions=pos)[:, -1]
    if routes is not None:
        layers = len(calls[0])
        routes.append((calls[0], [torch.cat(calls[1][i::layers])
                                  for i in range(layers)]))
    b1 = lm.decode_step(sp, cfg, nxt, torch.tensor([n], dtype=torch.int32,
                                                   device="cuda"), slot)
    return max((a0 - b0).abs().max().item(), (a1 - b1).abs().max().item())


def within_near_ties(got: dict, want: dict, margins: dict, d: float,
                     label: str) -> int:
    """Tokens of each request equal ``want``'s up to a near-tie: where
    they first differ, the reference route's top-2 margin must be below
    2D.  Returns the count of such ties."""
    ties = 0
    for rid, toks in want.items():
        mine = got[rid]
        if mine == toks:
            continue
        i = next(i for i, (a, b) in enumerate(zip(mine, toks)) if a != b)
        check(margins[rid][i] < 2 * d, f"{label}: rid {rid} diverges at "
              f"token {i} with a top-2 margin of {margins[rid][i]} (not "
              f"below 2D = {2 * d})")
        ties += 1
    return ties


def gemma3_phase(torch, timer) -> dict:
    """``[gemma3]``: full-width Gemma3-27B cut to ``GEMMA3_LAYERS`` layers
    (one group of 5 local + 1 global and the 2-local tail, the shape of
    the 62-layer stack's 10 x 6 + 2), seeded float32 weights, bf16
    activations.  Serves 4 requests of 1100-1400 tokens (past the 1024
    window: every ring wraps in prefill) and 32 new tokens through the
    slotted ``ServeEngine`` (OFF; rings of 1024 + 63 lines) and each alone
    through the lockstep path (kernel F on the global layer, the band on
    the local ones): tokens equal up to near-ties under the 2D guard.
    Then 2 of the requests with 16 new tokens in FUSED through the engine
    (kernel B with the gelu table on every gate) and alone through the
    lockstep path (kernel C on the global layer's prefill, B).  Kernels F
    and C are held against their plain versions at a lockstep prefill of
    1280 positions and at the first prompt's length, B (gelu) at every M
    the paths give the gate, N = 21504.  Last, ``GEMMA3_TRAIN``: two AdamW
    steps of the first group (the tail's masters freed) at 1 x 1280, past
    the window, so the band trains."""
    from repro_torch.core.engine import FUSED, OFF
    from repro_torch.kernels.dual_compute.ops import (
        fused_crossbar_acam, log_quantize_qkv, logdomain_flash_attention)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = cut_config("gemma3_27b", GEMMA3_LAYERS)
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[gemma3] {cfg.name} cut to {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B parameters (float32) in "
          f"{time.perf_counter() - t0:.1f} s")
    eng_kw = dict(max_slots=4, max_len=2048, prefill_chunk=64,
                  decode_block=4)
    reqs = gemma3_trace(cfg, 4, 32)
    out = {"layers": cfg.n_layers, "params_b": cfg.param_count() / 1e9}

    engine = ServeEngine(cfg, params, nldpe=OFF, **eng_kw)
    ring = engine.cache["ring"]["k"].shape[-2]
    res = serve(torch, engine, reqs, None, "gemma3 serve OFF")
    out["profile_serve_off"] = profile_window(
        torch, engine, gemma3_trace(cfg, 2, 8), "gemma3 serve OFF")
    sp = engine.params
    del engine
    torch.cuda.empty_cache()
    zero_counts()
    alone, margins = {}, {}
    t1 = time.perf_counter()
    for r in reqs:
        alone[r.rid], margins[r.rid] = greedy_alone(
            torch, cfg, sp, r.tokens, r.max_new_tokens, OFF)
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t1
    f_launches = flash_attention.launches
    check(f_launches == len(reqs), f"[gemma3] kernel F launched "
          f"{f_launches} times over {len(reqs)} lockstep prefills, "
          f"expected one each (the global layer)")
    d = window_route_deviation(torch, cfg, sp, reqs[0].tokens, 64)
    ties = within_near_ties(res["tokens"], alone, margins, d,
                            "[gemma3] engine vs run-alone")
    del sp
    torch.cuda.empty_cache()
    out["serve_off"] = {k: v for k, v in res.items() if k != "tokens"}
    out.update({"route_deviation_d": d, "near_ties": ties,
                "alone_s": alone_s, "flash_attention_launches": f_launches,
                "ring_lines_engine": ring,
                "positions_past_ring_engine": [
                    max(0, len(r.tokens) + r.max_new_tokens - 1 - ring)
                    for r in reqs],
                "positions_past_ring_lockstep": [
                    max(0, len(r.tokens) + r.max_new_tokens - 1
                        - cfg.window) for r in reqs]})

    fused_reqs = gemma3_trace(cfg, 2, 16)
    engine = ServeEngine(cfg, params, nldpe=FUSED, **eng_kw)
    res = serve(torch, engine, fused_reqs, fused_crossbar_acam,
                "gemma3 serve FUSED")
    sp = engine.params
    del engine
    out["serve_fused"] = {k: v for k, v in res.items() if k != "tokens"}
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    for r in fused_reqs:
        toks, _ = greedy_alone(torch, cfg, sp, r.tokens, r.max_new_tokens,
                               FUSED)
        check(len(toks) == r.max_new_tokens and all(
            0 <= t < cfg.vocab_size for t in toks),
            f"[gemma3] lockstep FUSED rid {r.rid}: bad tokens")
    torch.cuda.synchronize()
    lock_fused = {"wall_s": time.perf_counter() - t1,
                  "max_memory_allocated_gb":
                      torch.cuda.max_memory_allocated() / 1e9,
                  "launches": {fn.__name__: fn.launches
                               for fn in counters()}}
    n = len(fused_reqs)
    check(logdomain_flash_attention.launches == n
          and log_quantize_qkv.launches == n, f"[gemma3] lockstep FUSED: "
          f"kernel C launched {logdomain_flash_attention.launches} times "
          f"(quantize {log_quantize_qkv.launches}), expected {n}")
    steps = sum(r.max_new_tokens for r in fused_reqs)
    check(fused_crossbar_acam.launches == cfg.n_layers * steps,
          f"[gemma3] lockstep FUSED: kernel B launched "
          f"{fused_crossbar_acam.launches} times, expected one per layer "
          f"per prefill and decode step ({cfg.n_layers * steps})")
    out["lockstep_fused"] = lock_fused
    del sp
    torch.cuda.empty_cache()

    # the global layer's lockstep prefill at 1280 positions, inside the
    # trace's 1100-1400, for the row's timing; then at the first prompt's
    # own length (the lockstep OFF and FUSED prefills of rid 0), whose
    # last key tile is ragged: F against a dense masked softmax there, as
    # its plain version follows repro's blocking, which halves its blocks
    # until they divide the length (2 rows at 1110).  B at every M the
    # paths give the gate: GEMMA3_B_MS and the lockstep prefill's.
    plen = len(reqs[0].tokens)
    shape = (1, cfg.n_heads, cfg.n_kv_heads, GEMMA3_ATTN_LEN,
             GEMMA3_ATTN_LEN, cfg.resolved_head_dim)
    trace_shape = shape[:3] + (plen, plen) + shape[5:]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    w = params["groups"]["b0"]["ffn"]["gate"][0]
    cases = {"flash_attention": [
                 flash_case(torch, timer, shape, torch.bfloat16, SEED + 6),
                 flash_case(torch, timer, trace_shape, torch.bfloat16,
                            SEED + 6, dense=True)],
             "logdomain_flash_attention": [
                 logdomain_case(torch, timer, s_, torch.bfloat16, SEED + 7)
                 for s_ in (shape, trace_shape)],
             "fused_crossbar_acam": fused_acam_cases(
                 torch, timer, w, GEMMA3_B_MS + (plen,), "gelu", gen)}
    for c in sum(cases.values(), []):
        c["phase"] = "gemma3"
    # the train cut drops the tail: its masters go with the phase's tree
    tcfg, tparams = cut_depth(cfg, params, GEMMA3_TRAIN[0])
    del params, w
    out["train"] = family_train(torch, tcfg, tparams, GEMMA3_TRAIN[1],
                                "gemma3")
    del tparams
    torch.cuda.empty_cache()
    out["launches"] = {
        "flash_attention": {"lockstep_off": f_launches},
        "logdomain_flash_attention": {
            "lockstep_fused": lock_fused["launches"][
                "logdomain_flash_attention"]},
        "fused_crossbar_acam": {
            "serve_fused": out["serve_fused"]["launches"][
                "fused_crossbar_acam"],
            "serve_fused_per_prefill_chunk": out["serve_fused"][
                "launches_per_prefill_chunk"],
            "serve_fused_per_decode_tick": out["serve_fused"][
                "launches_per_decode_tick"],
            "lockstep_fused": lock_fused["launches"][
                "fused_crossbar_acam"]}}
    print("[gemma3 summary] " + json.dumps(out))
    out["kernel_cases"] = cases
    return out


def recurrentgemma_phase(torch, timer) -> dict:
    """``[recurrentgemma]``: full-width RecurrentGemma-9B cut to
    ``RGEMMA_LAYERS`` layers (rec, rec, local, then the rec, rec tail: the
    shape of the 38-layer stack's 12 x 3 + 2), seeded float32 weights,
    bf16 activations.  The lockstep path over 2 x 2304-token prompts (past
    the 2048 window: the local layer takes the band) and 32 new tokens in
    OFF (the generate fn and the per-token loop must give the same tokens)
    and in FUSED (kernel B with the gelu table on every gate, once per
    layer per prefill and decode step); then OFF over 1 x
    ``RGEMMA_F_LEN`` (at the window: the windowed layer's prefill takes
    kernel F at head dim 256, once per windowed layer).  Kernel B (gelu) is
    held against its plain version at the M the lockstep path gives the
    gate: 2 x 2304 at prefill and 2 at decode, K = 4096, N = 12288; kernel
    F at (1, 16/1, ``RGEMMA_F_LEN``, 256) against its plain version and
    the windowed ``blockwise_attention`` route.  Last, ``RGEMMA_TRAIN``:
    two AdamW steps of the 5 layers, tail included, at 1 x 2304 (past the
    window: the band and the RG-LRU scan train)."""
    from repro_torch.core.engine import FUSED, OFF
    from repro_torch.kernels.dual_compute.ops import fused_crossbar_acam
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = cut_config("recurrentgemma_9b", RGEMMA_LAYERS)
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[recurrentgemma] {cfg.name} cut to {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B parameters (float32) in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {"layers": cfg.n_layers, "params_b": cfg.param_count() / 1e9}
    batch, plen = 2, 2304
    out["off"] = lockstep(torch, cfg, params, OFF, batch=batch,
                          prompt_len=plen, gen_len=32, counters_on_path=[],
                          label="recurrentgemma lockstep OFF",
                          compare_loop=True)
    out["fused"] = lockstep(torch, cfg, params, FUSED, batch=batch,
                            prompt_len=plen, gen_len=32,
                            counters_on_path=[fused_crossbar_acam],
                            label="recurrentgemma lockstep FUSED",
                            compare_loop=False, profile=False)
    check(out["off"]["launches"]["flash_attention"] == 0,
          "[recurrentgemma] a prefill past the window launched kernel F")
    out["off_at_window"] = lockstep(
        torch, cfg, params, OFF, batch=1, prompt_len=RGEMMA_F_LEN,
        gen_len=8, counters_on_path=[],
        label="recurrentgemma lockstep OFF at the window",
        compare_loop=False, profile=False)
    local = sum(1 for t, *_ in lm.layer_order(cfg) if t == "local")
    f_launches = out["off_at_window"]["launches"]["flash_attention"]
    check(f_launches == local, f"[recurrentgemma] kernel F launched "
          f"{f_launches} times in a {RGEMMA_F_LEN}-token prefill, expected "
          f"one per windowed layer ({local})")
    w = params["groups"]["b0"]["ffn"]["gate"][0]
    cases = {"fused_crossbar_acam": fused_acam_cases(
        torch, timer, w, (batch, batch * plen), "gelu",
        torch.Generator(device="cuda").manual_seed(SEED + 8)),
        "flash_attention": [flash_case(
            torch, timer, (1, cfg.n_heads, cfg.n_kv_heads, RGEMMA_F_LEN,
                           RGEMMA_F_LEN, cfg.resolved_head_dim), dt,
            SEED + 9, window=cfg.window)
            for dt in (torch.bfloat16, torch.float32)]}
    for c in sum(cases.values(), []):
        c["phase"] = "recurrentgemma"
    del w
    out["train"] = family_train(torch, cfg, params, RGEMMA_TRAIN,
                                "recurrentgemma")
    del params
    torch.cuda.empty_cache()
    out["launches"] = {
        "fused_crossbar_acam": {
            "lockstep_fused": out["fused"]["launches"][
                "fused_crossbar_acam"]},
        "flash_attention": {"lockstep_off_at_window": f_launches,
                            "lockstep_off_past_window": 0}}
    out["kernel_cases"] = cases
    return out


def qwen3moe_phase(torch, timer) -> dict:
    """``[qwen3moe]``: full-width Qwen3-30B-A3B (128 experts, top 8,
    d_expert_ff 768, 32/4 heads of 128) cut to ``QWEN3MOE_LAYERS`` MoE
    layers, seeded float32 weights, bf16 activations.  Serves paged OFF's
    trace and settings through ``PagedServeEngine`` at the published
    capacity factor 1.25 (kernel A on every layer; dropped assignments
    counted per prefill chunk and per decode tick, live tokens' apart
    from padding rows', none at decode: 8 tokens give an expert at most 8
    assignments, the minimum capacity), profiles a window (``moe_profile``:
    the expert FFN's and the write-masked rows' dense attention's share of
    busy time) and holds kernel A against its plain version on the
    engine's own pool.  Then a dropless twin (capacity factor 0) over 4
    requests, 16 new tokens, through ``PagedServeEngine``, ``ServeEngine``
    and each request alone through the lockstep path (kernel F on every
    layer): equal tokens up to near-ties under 2D.  The twin runs float32
    activations: at bf16 the routes' logits part by ~2, where a near-tie
    guard means nothing; the routing flips between the chunked and the
    lockstep prefill of the first request, counted at bf16 and at
    float32, show why (a flipped expert in an early layer moves every
    later one).
    Then the lockstep FUSED path, 2 x 512 and 8 new (kernel C on every
    layer, kernel B on none: the experts never reach it), two AdamW steps
    of the first 4 layers at 2 x 512 and capacity 1.25
    (``QWEN3MOE_TRAIN``), F and C at ``QWEN3MOE_ATTN``, and last
    Llama4-Scout (``llama4_scout``), its kernel cases joining the
    phase's."""
    from repro_torch.core.engine import FUSED, OFF
    from repro_torch.kernels.dual_compute.ops import (
        fused_crossbar_acam, log_quantize_qkv, logdomain_flash_attention)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.engine import PagedServeEngine, ServeEngine
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = cut_config("qwen3_moe_30b_a3b", QWEN3MOE_LAYERS)
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[qwen3moe] {cfg.name} cut to {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B parameters (float32; "
          f"{cfg.active_param_count() / 1e9:.3f} B active a token) in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {"layers": cfg.n_layers, "params_b": cfg.param_count() / 1e9,
           "active_params_b": cfg.active_param_count() / 1e9,
           "capacity_factor": cfg.moe.capacity_factor}
    paged_kw = dict(max_slots=8, max_len=1024, page_size=16,
                    prefill_chunk=64, decode_block=4)
    engine = PagedServeEngine(cfg, params, nldpe=OFF, **paged_kw)
    res = serve(torch, engine, make_trace(cfg, 8, 32, 0), paged_attention,
                "qwen3moe serve OFF")
    n = cfg.n_layers
    check(res["launches_per_prefill_chunk"] == n
          and res["launches_per_decode_tick"] == n * paged_kw[
              "decode_block"], f"[qwen3moe] kernel A launched "
          f"{res['launches_per_prefill_chunk']} times a prefill chunk and "
          f"{res['launches_per_decode_tick']} a decode tick, expected one "
          f"per MoE layer and step")
    moe = res["moe"]
    check(moe["dropped_decode"] == 0, f"[qwen3moe] {moe['dropped_decode']} "
          f"assignments dropped at decode (8 tokens a step cannot "
          f"overflow the minimum capacity of 8)")
    out["serve_off"] = {k: v for k, v in res.items() if k != "tokens"}
    out["dropped_per_prefill_chunk"] = moe["dropped_per_prefill_forward"]
    out["dropped_pad_per_prefill_chunk"] = moe[
        "dropped_pad_per_prefill_forward"]
    out["dropped_per_decode_tick"] = (moe["dropped_decode"]
                                      / max(res["decode_ticks"], 1))
    # a 2-request window: with the host's ops recorded, reading back the
    # trace of 4 took ~40 s
    out["profile_serve_off"] = moe_profile(
        torch, engine, make_trace(cfg, 2, 32, 0), "qwen3moe serve OFF")
    a_in = kernel_a_inputs(engine)
    del engine
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    a_cases = []
    for q_len in (1, 64):
        q = torch.randn((a_in["bt"].shape[0], cfg.n_heads, q_len,
                         cfg.resolved_head_dim), generator=gen,
                        device="cuda")
        a_cases.append(paged_case(torch, timer, a_in, q, a_in["k"],
                                  a_in["v"], {}, "float32"))
    del a_in

    # the dropless twin: every token's output its own, so the paged, the
    # slotted and the run-alone routes differ by float rounding only
    cfg0 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.0))
    reqs = make_trace(cfg0, 4, 16, 0)
    sp = lm.serving_params(params, cfg0)
    chunk = QWEN3MOE_TWIN["prefill_chunk"]
    bf16_routes = []
    bf16_d = max(window_route_deviation(torch, cfg0, sp, reqs[0].tokens,
                                        chunk, routes=bf16_routes),
                 window_route_deviation(torch, cfg0, sp, reqs[0].tokens,
                                        chunk, page_size=16,
                                        routes=bf16_routes))
    del sp
    cfg0 = dataclasses.replace(cfg0, activation_dtype=torch.float32)
    twin_kw = dict(QWEN3MOE_TWIN)
    engine = PagedServeEngine(cfg0, params, nldpe=OFF, **twin_kw)
    paged_res = serve(torch, engine, reqs, paged_attention,
                      "qwen3moe dropless serve paged")
    del engine
    torch.cuda.empty_cache()
    twin_kw.pop("page_size")
    engine = ServeEngine(cfg0, params, nldpe=OFF, **twin_kw)
    slot_res = serve(torch, engine, reqs, None,
                     "qwen3moe dropless serve slotted")
    sp = engine.params
    del engine
    torch.cuda.empty_cache()
    zero_counts()
    alone, margins = {}, {}
    t1 = time.perf_counter()
    for r in reqs:
        alone[r.rid], margins[r.rid] = greedy_alone(
            torch, cfg0, sp, r.tokens, r.max_new_tokens, OFF)
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t1
    f_launches = flash_attention.launches
    check(f_launches == n * len(reqs), f"[qwen3moe] kernel F launched "
          f"{f_launches} times over {len(reqs)} lockstep prefills, "
          f"expected one per layer ({n * len(reqs)})")
    f32_routes = []
    d = max(window_route_deviation(torch, cfg0, sp, reqs[0].tokens, chunk,
                                   routes=f32_routes),
            window_route_deviation(torch, cfg0, sp, reqs[0].tokens, chunk,
                                   page_size=16, routes=f32_routes))
    flips = {f"{dt}_{route}_vs_alone": route_flips(r)
             for dt, rs in (("bf16", bf16_routes), ("float32", f32_routes))
             for route, r in zip(("slotted", "paged"), rs)}
    print(f"[qwen3moe routes] rid {reqs[0].rid}: " + json.dumps(flips))
    ties = {"paged": within_near_ties(paged_res["tokens"], alone, margins, d,
                                      "[qwen3moe] dropless paged vs alone"),
            "slotted": within_near_ties(
                slot_res["tokens"], alone, margins, d,
                "[qwen3moe] dropless slotted vs alone")}
    del sp
    torch.cuda.empty_cache()
    out["dropless"] = {
        "paged": {k: v for k, v in paged_res.items() if k != "tokens"},
        "slotted": {k: v for k, v in slot_res.items() if k != "tokens"},
        "activations": "float32", "prefill_chunk": chunk,
        "route_deviation_d": d, "bf16_route_deviation_d": bf16_d,
        "routing_flips": flips,
        "near_ties": ties, "alone_s": alone_s,
        "flash_attention_launches": f_launches,
        "paged_equals_slotted": paged_res["tokens"] == slot_res["tokens"],
        "paged_equals_alone": paged_res["tokens"] == alone}
    print("[qwen3moe dropless] " + json.dumps(out["dropless"]))

    lock_fused = lockstep(torch, cfg, params, FUSED, batch=2, prompt_len=512,
                          gen_len=8, counters_on_path=[
                              logdomain_flash_attention, log_quantize_qkv],
                          label="qwen3moe lockstep FUSED",
                          compare_loop=False, profile=False)
    check(lock_fused["launches"]["fused_crossbar_acam"] == 0,
          "[qwen3moe] lockstep FUSED launched kernel B: the experts' gate "
          "is an einsum then an ACAM activation, never kernel B")
    out["lockstep_fused"] = {k: v for k, v in lock_fused.items()
                             if k != "per_kernel"}
    tcfg, tparams = cut_depth(cfg, params, QWEN3MOE_TRAIN[0])
    out["train"] = family_train(torch, tcfg, tparams, QWEN3MOE_TRAIN[1],
                                "qwen3moe")
    del tparams, params
    torch.cuda.empty_cache()
    cases = {"paged_attention": a_cases,
             "flash_attention": [flash_case(torch, timer, QWEN3MOE_ATTN, dt,
                                            SEED + 12)
                                 for dt in (torch.bfloat16, torch.float32)],
             "logdomain_flash_attention": [logdomain_case(
                 torch, timer, QWEN3MOE_ATTN, torch.bfloat16, SEED + 13)]}
    for c in sum(cases.values(), []):
        c["phase"] = "qwen3moe"
    out["launches"] = {
        "paged_attention": {
            "serve_off": res["launches"]["paged_attention"],
            "serve_off_per_prefill_chunk": res["launches_per_prefill_chunk"],
            "serve_off_per_decode_tick": res["launches_per_decode_tick"],
            "dropless_paged": paged_res["launches"]["paged_attention"]},
        "flash_attention": {"lockstep_off_alone": f_launches},
        "logdomain_flash_attention": {
            "lockstep_fused": lock_fused["launches"][
                "logdomain_flash_attention"],
            "lockstep_fused_per_prefill": lock_fused["per_kernel"][
                "logdomain_flash_attention"]["launches_per_prefill"]}}
    print("[qwen3moe summary] " + json.dumps(out))
    t0 = time.perf_counter()
    scout = llama4_scout(torch, timer)
    print(f"[llama4 scout] {time.perf_counter() - t0:.1f} s")
    for name, cs in scout.pop("kernel_cases").items():
        if cs:
            cases[name] += cs
    for name, n in scout["launches"].items():
        out["launches"].setdefault(name, {}).update(
            {f"llama4_scout_{k}": v for k, v in n.items()})
    out["llama4_scout"] = scout
    out["kernel_cases"] = cases
    return out


def llama4_scout(torch, timer) -> dict:
    """``[qwen3moe]``'s Llama4-Scout-17B-16E at full width (d 5120, 40/8
    heads of 128, 16 experts of d_ff 8192, top 1, vocab 202048) cut to
    ``LLAMA4_LAYERS`` of its 48 layers, seeded float32 weights, through
    ``family_phase``: paged OFF (kernel A at GQA 5), each request alone
    through the lockstep path (kernel F at 40/8) and lockstep FUSED 2 x 256
    (kernel C on every layer; B on none: the experts are batched
    matmuls), A, F and C against their plain versions.  Dropless and at
    float32 activations, as ``[qwen3moe]``'s twin, so that the run-alone
    comparison means something: under a capacity a token's experts
    depend on the other rows of its forward, and at bf16 a top-1 router
    near-tie flips between the chunked and the whole-prompt prefill."""
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = cut_config("llama4_scout_17b_a16e", LLAMA4_LAYERS)
    cfg = dataclasses.replace(
        cfg, activation_dtype=torch.float32,
        moe=dataclasses.replace(cfg.moe, capacity_factor=0.0))
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[llama4 scout] {cfg.name} cut to {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B parameters (float32; "
          f"{cfg.active_param_count() / 1e9:.3f} B active a token) in "
          f"{time.perf_counter() - t0:.1f} s")
    out = family_phase(torch, timer, cfg, params, None, "llama4 scout",
                       SEED + 43)
    out.update(activations="float32", capacity_factor=0.0,
               active_params_b=cfg.active_param_count() / 1e9)
    del params
    torch.cuda.empty_cache()
    return family_summary(out, "llama4 scout")


def moe_profile(torch, engine, reqs, label: str) -> dict:
    """``profile_window``'s window and outputs (busy and idle share, top
    kernels, the port's kernels) with the host's ops recorded too, and two
    functions each under a ``record_function`` range:
    ``nn.moe.expert_ffn`` (the experts' three batched matmuls and their
    activation) and ``nn.attention.cached_attention`` (on this path only
    the masked dense route of the write-masked rows, ``dense_rows``).  A
    range's device time is the sum of the durations CUPTI gives the
    kernels launched inside it (no idle gaps), its share that of the
    window's busy time."""
    import repro_torch.nn.attention as attention
    import repro_torch.nn.moe as moe
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    spans = {"expert_ffn": (moe, "expert_ffn"),
             "dense_rows_attention": (attention, "cached_attention")}
    plain = {tag: getattr(mod, name) for tag, (mod, name) in spans.items()}

    def ranged(tag):
        def call(*args, **kwargs):
            with record_function(tag):
                return plain[tag](*args, **kwargs)
        return call

    again = [dataclasses.replace(r, rid=100 + r.rid, arrival=engine.tick)
             for r in reqs]
    for tag, (mod, name) in spans.items():
        setattr(mod, name, ranged(tag))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            engine.run(again)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for tag, (mod, name) in spans.items():
            setattr(mod, name, plain[tag])
    events = p.events()
    # device events alone: the host ops carry their kernels' time too
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in spans:
            by_name[e.name] = by_name.get(e.name, 0) + e.device_time_total
    busy = sum(by_name.values()) / 1e6
    port = {}
    for name in PORT_KERNELS:
        ms = sum(us for k, us in by_name.items()
                 if f"{name}_kernel" in k) / 1e3
        if ms:
            port[name] = {"ms": ms, "share_of_busy": ms / 1e3 / busy}
    out = {"wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1 - busy / wall,
           "top_kernels_ms": [[k[:90], us / 1e3] for k, us in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:8]],
           "port_kernels": port, "host_ops_recorded": True}
    print(f"[{label} profile] " + json.dumps(out))
    for tag in spans:
        ranges = [e for e in events
                  if e.device_type == DeviceType.CPU and e.name == tag]
        ms = sum(e.device_time_total for e in ranges) / 1e3
        out[tag] = {"calls": len(ranges), "device_ms": ms,
                    "share_of_busy": ms / 1e3 / busy}
        print(f"[{label} {tag}] " + json.dumps(out[tag]))
    ffn = out["expert_ffn"]
    check(ffn["calls"] > 0 and 0 < ffn["device_ms"] <= busy * 1e3,
          f"[{label}] the profiler gave the expert FFN's ranges "
          f"{ffn['device_ms']} ms of kernels in {busy * 1e3} ms busy")
    return out


def rwkv6_phase(torch) -> dict:
    """``[rwkv6]``: full-width RWKV6-3B (d 2560, 40 heads of 64, d_ff 8960,
    vocab 65536) at ``RWKV6_LAYERS`` layers, seeded float32 weights, bf16
    activations, through the lockstep path: ``OFF`` over 2 x 2048-token
    prompts (16 chunks of 128) and 32 new tokens, the generate fn and the
    per-token loop giving the same tokens; then ``ON`` (the lerps' and
    gate's products through log-domain DMMul, the decay through two ACAM
    exp tables) over 1 x 1024 and 8 new.  No port kernel lies on this
    path: every count must stay 0.  Last, ``RWKV6_TRAIN``: two AdamW
    steps of all 32 layers at 1 x 2048 (16 WKV chunks under autograd)."""
    from repro_torch.core.engine import OFF, ON
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = cut_config("rwkv6_3b", RWKV6_LAYERS)
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[rwkv6] {cfg.name} at {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B parameters (float32) in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {"layers": cfg.n_layers, "params_b": cfg.param_count() / 1e9,
           "port_kernels_on_path": "none (plain PyTorch: the chunked WKV, "
                                   "the projections, the ACAM tables' "
                                   "piecewise path)"}
    out["off"] = lockstep(torch, cfg, params, OFF, batch=2, prompt_len=2048,
                          gen_len=32, counters_on_path=[],
                          label="rwkv6 lockstep OFF", compare_loop=True,
                          profile=False)
    out["on"] = lockstep(torch, cfg, params, ON, batch=1, prompt_len=1024,
                         gen_len=8, counters_on_path=[],
                         label="rwkv6 lockstep ON", compare_loop=False,
                         profile=False)
    for mode in ("off", "on"):
        launched = {k: v for k, v in out[mode]["launches"].items() if v}
        check(not launched, f"[rwkv6] {mode}: port kernels launched on an "
              f"attention-free path: {launched}")
    out["train"] = family_train(torch, cfg, params, RWKV6_TRAIN, "rwkv6")
    del params
    torch.cuda.empty_cache()
    print("[rwkv6 summary] " + json.dumps(
        {"layers": cfg.n_layers, "port_kernels_on_path": "none",
         "off_prefill_s": out["off"]["prefill_s"],
         "off_decode_ms_per_step": out["off"]["decode_ms_per_step"],
         "off_loop_tokens_equal": out["off"]["loop_tokens_equal"],
         "on_prefill_s": out["on"]["prefill_s"],
         "on_decode_ms_per_step": out["on"]["decode_ms_per_step"],
         "max_memory_allocated_gb": max(
             out[m]["max_memory_allocated_gb"] for m in ("off", "on"))}))
    return out


def prefix_lockstep(torch, cfg, sp, *, batch: int, gen_len: int,
                    label: str) -> dict:
    """The lockstep path of ``launch/serve.py`` with an image prefix:
    ``batch`` requests of ``PALIGEMMA_PREFIX`` (seeded patch-embedding rows,
    random text tokens), one whole prefill over the prefix-LM mask (the
    masked ``blockwise_attention``: kernel F is causal only, so no port
    kernel may launch), then ``gen_len`` greedy tokens from position P + S
    through the generate fn and, from a copy of the prefilled cache, the
    per-token loop: the tokens must be identical."""
    from repro_torch.launch.serve import (build_decode_step,
                                          build_generate_fn,
                                          build_prefill_step,
                                          python_loop_decode)
    from repro_torch.models import lm
    n_patches, text_len = PALIGEMMA_PREFIX
    prefill = build_prefill_step(cfg)
    generate = build_generate_fn(cfg, gen_len)
    rng = np.random.default_rng(SEED + 25)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (batch, text_len)),
                           dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    patches = torch.randn((batch, n_patches, cfg.d_model), generator=gen,
                          device="cuda")
    start = n_patches + text_len
    warm = lm.init_model_cache(cfg, batch, 40, device="cuda")
    last, warm = prefill(sp, warm, toks[:, :16], patches[:, :16])
    build_generate_fn(cfg, 3)(sp, warm, torch.argmax(last, -1).to(
        torch.int32), 32)
    del warm
    cache = lm.init_model_cache(cfg, batch, start + gen_len, device="cuda")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last, cache = prefill(sp, cache, toks, patches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launched = {fn.__name__: fn.launches for fn in counters()
                if fn.launches}
    check(not launched, f"{label}: the prefix route launched {launched} "
          f"(the prefix-LM mask takes the masked blockwise attention)")
    check(bool(torch.isfinite(last).all()), f"{label}: non-finite logits")
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    spare = lm.clone_cache(cache)
    t0 = time.perf_counter()
    out_toks, cache = generate(sp, cache, tok, start)
    out_toks = out_toks.cpu()
    decode_s = time.perf_counter() - t0
    steps = gen_len - 1
    check(bool(((out_toks >= 0) & (out_toks < cfg.vocab_size)).all())
          and tuple(out_toks.shape) == (batch, gen_len),
          f"{label}: bad tokens")
    loop, _ = python_loop_decode(build_decode_step(cfg), sp, spare, tok,
                                 start, gen_len)
    check(torch.equal(loop, out_toks), f"{label}: generate fn and python "
          f"loop tokens differ")
    out = {"batch": batch, "prefix_rows": n_patches, "text_len": text_len,
           "decode_from": start, "gen_len": gen_len, "prefill_s": prefill_s,
           "prefill_positions_per_s": batch * start / prefill_s,
           "decode_ms_per_step": decode_s * 1e3 / steps,
           "generated_tokens_per_s": batch * steps / decode_s,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "port_kernels_in_prefill": 0, "loop_tokens_equal": True,
           "sample_row": out_toks[0, :12].tolist()}
    print(f"[{label}] " + json.dumps(out))
    return out


def alone_against_paged(torch, cfg, sp, res: dict, reqs, label: str) -> dict:
    """Each request of a served paged trace alone through the lockstep
    path (kernel F in every layer's prefill): its tokens must equal the
    paged engine's up to near-ties under 2D, D the route deviation between
    the lockstep prefill and the paged chunked one on the same weights."""
    from repro_torch.core.engine import OFF
    from repro_torch.kernels.flash_attention.ops import flash_attention
    zero_counts()
    alone, margins = {}, {}
    t0 = time.perf_counter()
    for r in reqs:
        alone[r.rid], margins[r.rid] = greedy_alone(
            torch, cfg, sp, r.tokens, r.max_new_tokens, OFF)
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    f_launches = flash_attention.launches
    check(f_launches == cfg.n_layers * len(reqs), f"{label}: kernel F "
          f"launched {f_launches} times over {len(reqs)} lockstep "
          f"prefills, expected one per layer ({cfg.n_layers * len(reqs)})")
    d = window_route_deviation(torch, cfg, sp, reqs[0].tokens, 64,
                               page_size=16)
    ties = within_near_ties(res["tokens"], alone, margins, d,
                            f"{label} paged vs run-alone")
    return {"route_deviation_d": d, "near_ties": ties, "alone_s": alone_s,
            "flash_attention_launches": f_launches,
            "flash_attention_per_prefill": f_launches / len(reqs),
            "paged_equals_alone": res["tokens"] == alone}


def paged_cases_all_pools(torch, timer, a_in: dict, n_heads: int,
                          seed: int) -> list:
    """Kernel A on a served engine's own layer-0 pools and block table
    (``kernel_a_inputs``): decode (Q = 1) and a chunk of Q = 64, over the
    f32 pool, its bf16 cast, and the same K/V on the int8 and log8 grids."""
    from repro_torch.nn.attention import _quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k0, v0 = a_in["k"], a_in["v"]
    cases = []
    for q_len in (1, 64):
        q = torch.randn((a_in["bt"].shape[0], n_heads, q_len, k0.shape[-1]),
                        generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            cases.append(paged_case(torch, timer, a_in, q, k0.to(dt),
                                    v0.to(dt), {}, str(dt).split(".")[-1]))
        for mode in ("int8", "log8"):
            (kc, ks), (vc, vs) = _quantize_kv(k0, mode), _quantize_kv(v0,
                                                                        mode)
            cases.append(paged_case(
                torch, timer, a_in, q, kc, vc,
                dict(k_scale=ks, v_scale=vs, kv_quant=mode), mode))
    return cases


def family_phase(torch, timer, cfg, params, ffn: str | None, label: str,
                 seed: int) -> dict:
    """The serving paths and kernel cases ``[paligemma]``, ``[musicgen]``
    and ``[qwen3moe]``'s Llama4-Scout share: ``PagedServeEngine`` OFF on
    paged OFF's trace, 4 requests (kernel A once per layer every prefill
    chunk and decode step), each request alone through the lockstep path
    (kernel F in every layer's prefill; tokens equal up to near-ties under
    2D), and the lockstep FUSED path, 2 x 256 text tokens, 8 new (kernel C
    in every layer's prefill, kernel B with the gelu table on the ``ffn``
    projection; with ``ffn`` None, an MoE model's, B on no layer).  Then A
    on the engine's layer-0 pools (decode, Q = 64; f32, bf16, int8 and
    log8), F at the first prompt's length (against a dense masked softmax
    there), and C and B at the lockstep FUSED prefill's own shape, against
    their plain versions; F and C in ``cfg.activation_dtype``, the dtype
    the paths hand them (float32 for Llama4-Scout, bf16 otherwise).
    Returns the phase's results with its ``"launches"`` by kernel, its
    ``"kernel_cases"`` and the first prompt's length (``"plen"``)."""
    from repro_torch.core.engine import FUSED, OFF
    from repro_torch.kernels.dual_compute.ops import (
        fused_crossbar_acam, log_quantize_qkv, logdomain_flash_attention)
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.engine import PagedServeEngine
    n = cfg.n_layers
    out = {"layers": n, "params_b": cfg.param_count() / 1e9}
    paged_kw = dict(max_slots=8, max_len=1024, page_size=16,
                    prefill_chunk=64, decode_block=4)
    reqs = make_trace(cfg, 4, 32, 0)
    engine = PagedServeEngine(cfg, params, nldpe=OFF, **paged_kw)
    res = serve(torch, engine, reqs, paged_attention, f"{label} serve OFF")
    check(res["launches_per_prefill_chunk"] == n
          and res["launches_per_decode_tick"] == n * paged_kw[
              "decode_block"], f"[{label}] kernel A launched "
          f"{res['launches_per_prefill_chunk']} times a prefill chunk and "
          f"{res['launches_per_decode_tick']} a decode tick, expected one "
          f"per layer and step")
    a_in = kernel_a_inputs(engine)
    sp = engine.params
    del engine
    torch.cuda.empty_cache()
    out["serve_off"] = {k: v for k, v in res.items() if k != "tokens"}
    out["alone"] = alone_against_paged(torch, cfg, sp, res, reqs,
                                       f"[{label}]")
    print(f"[{label} alone] " + json.dumps(out["alone"]))
    del sp
    torch.cuda.empty_cache()

    batch, prompt_len = 2, 256
    on_path = [logdomain_flash_attention, log_quantize_qkv]
    if ffn is not None:
        on_path.append(fused_crossbar_acam)
    lock_fused = lockstep(torch, cfg, params, FUSED, batch=batch,
                          prompt_len=prompt_len, gen_len=8,
                          counters_on_path=on_path,
                          label=f"{label} lockstep FUSED",
                          compare_loop=False, profile=False)
    if ffn is None:
        check(lock_fused["launches"]["fused_crossbar_acam"] == 0,
              f"[{label}] lockstep FUSED launched kernel B: the experts' "
              f"gate is a batched matmul then an ACAM activation")
    out["lockstep_fused"] = {k: v for k, v in lock_fused.items()
                             if k != "per_kernel"}
    plen = len(reqs[0].tokens)
    d = cfg.resolved_head_dim
    heads = (cfg.n_heads, cfg.n_kv_heads)
    act = cfg.activation_dtype      # the dtype F and C take on these paths
    out["plen"] = plen
    out["kernel_cases"] = {
        "paged_attention": paged_cases_all_pools(torch, timer, a_in,
                                                 cfg.n_heads, seed),
        "flash_attention": [flash_case(
            torch, timer, (1, *heads, plen, plen, d), act, seed + 1,
            dense=True)],
        "logdomain_flash_attention": [logdomain_case(
            torch, timer, (batch, *heads, prompt_len, prompt_len, d), act,
            seed + 2)],
        "fused_crossbar_acam": [] if ffn is None else fused_acam_cases(
            torch, timer, params["groups"]["b0"]["ffn"][ffn][0],
            (batch * prompt_len, batch), "gelu",
            torch.Generator(device="cuda").manual_seed(seed + 3))}
    del a_in
    per = lock_fused["per_kernel"]
    out["launches"] = {
        "paged_attention": {
            "serve_off": res["launches"]["paged_attention"],
            "serve_off_per_prefill_chunk": res["launches_per_prefill_chunk"],
            "serve_off_per_decode_tick": res["launches_per_decode_tick"]},
        "flash_attention": {
            "lockstep_off_alone": out["alone"]["flash_attention_launches"],
            "lockstep_off_alone_per_prefill": out["alone"][
                "flash_attention_per_prefill"]},
        "logdomain_flash_attention": {
            "lockstep_fused": per["logdomain_flash_attention"]["launches"],
            "lockstep_fused_per_prefill": per["logdomain_flash_attention"][
                "launches_per_prefill"]}}
    if ffn is not None:
        out["launches"]["fused_crossbar_acam"] = {
            "lockstep_fused": per["fused_crossbar_acam"]["launches"],
            "lockstep_fused_per_prefill": per["fused_crossbar_acam"][
                "launches_per_prefill"],
            "lockstep_fused_per_decode_step": per["fused_crossbar_acam"][
                "launches_per_decode_step"]}
    return out


def family_summary(out: dict, label: str) -> dict:
    """Tags each kernel case with its phase and prints the summary line
    (the cases go to the kernel rows, not into the line)."""
    cases = out.pop("kernel_cases")
    for c in sum(cases.values(), []):
        c["phase"] = label
    print(f"[{label} summary] " + json.dumps(out))
    out["kernel_cases"] = cases
    return out


def paligemma_phase(torch, timer) -> dict:
    """``[paligemma]``: PaliGemma-3B at full width and depth (18 layers,
    d 2048, 8/1 heads of 256, GeGLU d_ff 16384, vocab 257216, tied
    embeddings), seeded float32 weights, bf16 activations.  The lockstep
    path with an image prefix (``prefix_lockstep``: 2 requests of 256
    patch rows and 256 text tokens, 32 new), then ``family_phase`` on the
    text-only paths: kernel A's head-dim-256 decode and chunk instances, F
    at D 256, C at D 256 (the resident instance at the FUSED prefill's 256
    keys) and B on every gate.  Besides the shared cases, F and C at (1,
    8/1, 1280, 256) and C at (1, 16/1, ``RGEMMA_F_LEN``, 256), both
    two-pass."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = get_config("paligemma_3b")
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[paligemma] {cfg.name} at {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B parameters (float32) in "
          f"{time.perf_counter() - t0:.1f} s")
    sp = lm.serving_params(params, cfg)
    prefix = prefix_lockstep(torch, cfg, sp, batch=2, gen_len=32,
                             label="paligemma lockstep OFF prefix")
    del sp
    torch.cuda.empty_cache()
    out = family_phase(torch, timer, cfg, params, "gate", "paligemma",
                       SEED + 27)
    out["prefix_lockstep"] = prefix
    out["launches"]["flash_attention"]["lockstep_off_prefix"] = 0
    d = cfg.resolved_head_dim
    shape = (1, cfg.n_heads, cfg.n_kv_heads, PALIGEMMA_ATTN_LEN,
             PALIGEMMA_ATTN_LEN, d)
    plen = out["plen"]
    cases = out["kernel_cases"]
    cases["flash_attention"] += [
        flash_case(torch, timer, shape, dt, SEED + 31)
        for dt in (torch.bfloat16, torch.float32)]
    cases["logdomain_flash_attention"] += [
        logdomain_case(torch, timer, s_, torch.bfloat16, SEED + 32)
        for s_ in (shape, shape[:3] + (plen, plen, d),
                   (1, 16, 1, RGEMMA_F_LEN, RGEMMA_F_LEN, d))]
    del params
    torch.cuda.empty_cache()
    return family_summary(out, "paligemma")


def musicgen_phase(torch, timer) -> dict:
    """``[musicgen]``: MusicGen-large's decoder over EnCodec token ids at
    full width (d 2048, 32/32 heads of 64, plain GELU d_ff 8192, vocab
    2048) cut to ``MUSICGEN_LAYERS`` of its 48 layers, seeded float32
    weights, bf16 activations, through ``family_phase``: kernel A at GQA
    1, F (MHA), C, and B with the gelu table on the non-gated up
    projection."""
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = cut_config("musicgen_large", MUSICGEN_LAYERS)
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[musicgen] {cfg.name} cut to {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B parameters (float32) in "
          f"{time.perf_counter() - t0:.1f} s")
    out = family_phase(torch, timer, cfg, params, "up", "musicgen",
                       SEED + 33)
    del params
    torch.cuda.empty_cache()
    return family_summary(out, "musicgen")


def small_model_agrees(torch) -> None:
    """The reduced model (float32 activations) served on the card through
    the kernels and on the CPU through the plain versions gives the same
    greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import PagedServeEngine, Request
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    rng = np.random.default_rng(SEED)
    shared = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 12))
    reqs = [Request(rid=i, tokens=shared + tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, 1 + 2 * i)), max_new_tokens=8, arrival=i)
        for i in range(6)]
    for kv_quant in (None, "int8", "log8"):
        tokens = {}
        for dev in ("cpu", "cuda"):
            params = {k: _to(v, dev) for k, v in cpu.items()}
            eng = PagedServeEngine(cfg, params, max_slots=3, max_len=48,
                                   page_size=4, prefill_chunk=8,
                                   decode_block=2, kv_quant=kv_quant,
                                   device=dev)
            tokens[dev] = {c.rid: c.tokens for c in eng.run(reqs)}
        pools = kv_quant or "f32"
        check(tokens["cpu"] == tokens["cuda"], f"small model, {pools} "
              f"pools: card and CPU tokens differ: {tokens}")
        print(f"[reference] small model, {pools} pools: card tokens == CPU "
              f"plain-path tokens")
    # lockstep prefill (kernel F; kernels C and B): last logits against the
    # CPU plain path.  Three attention implementations meet near-flat
    # random-weight logits here, so logits are compared, not tokens.
    from repro_torch.core.engine import FUSED, OFF
    from repro_torch.launch.serve import build_prefill_step
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 29)),
                              dtype=torch.int32)
    for nldpe, tol in ((OFF, 1e-4), (FUSED, 1e-2)):
        last = {}
        for dev in ("cpu", "cuda"):
            params = lm.serving_params({k: _to(v, dev)
                                        for k, v in cpu.items()}, cfg, nldpe)
            cache = lm.init_model_cache(cfg, 3, 32, device=dev)
            last[dev] = build_prefill_step(cfg, nldpe=nldpe)(
                params, cache, prompts.to(dev))[0].cpu()
        err = (last["cpu"] - last["cuda"]).abs().max().item()
        name = "FUSED" if nldpe.enabled else "OFF"
        check(err <= tol, f"small model lockstep {name}: card vs CPU last "
              f"logits {err} > {tol}")
        print(f"[reference] small model lockstep {name}: card vs CPU last "
              f"logits max |diff| {err:.3g} (tolerance {tol})")
    windowed_models_agree(torch, rng)
    moe_rwkv_models_agree(torch, rng)
    vlm_audio_models_agree(torch, rng)


def vlm_audio_models_agree(torch, rng) -> None:
    """The reduced PaliGemma (float32 activations) through the lockstep
    path with an image prefix (the masked prefix-LM route) on the card and
    on the CPU: a 2 x (8 patches + 20 tokens) prefill and 4 decode steps
    from position 28, ``OFF`` logits within ``WINDOWED_TOL``; the reduced
    MusicGen through ``PagedServeEngine`` (kernel A on every layer): equal
    greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import PagedServeEngine, Request
    from repro_torch.launch.serve import build_prefill_step
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("paligemma_3b", reduced=True),
                              activation_dtype=torch.float32)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)),
                           dtype=torch.int32)
    patches = torch.as_tensor(rng.normal(size=(2, cfg.n_patches,
                                               cfg.d_model)),
                              dtype=torch.float32)
    start = cfg.n_patches + 20
    logits = {}
    for dev in ("cpu", "cuda"):
        p = lm.serving_params(_to(cpu, dev), cfg)
        cache = lm.init_model_cache(cfg, 2, start + 4, device=dev)
        out = [build_prefill_step(cfg)(p, cache, toks[:, :20].to(dev),
                                       patches.to(dev))[0]]
        for t in range(20, 24):
            out.append(lm.decode_step(p, cfg, toks[:, t].to(dev),
                                      cfg.n_patches + t, cache))
        logits[dev] = torch.stack([o.cpu() for o in out])
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    check(err <= WINDOWED_TOL, f"reduced paligemma_3b with an image "
          f"prefix: card vs CPU OFF logits {err} > {WINDOWED_TOL}")
    print(f"[reference] reduced paligemma_3b with an image prefix: card vs "
          f"CPU OFF logits max |diff| {err:.3g} (tolerance {WINDOWED_TOL})")
    cfg = dataclasses.replace(get_config("musicgen_large", reduced=True),
                              activation_dtype=torch.float32)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    reqs = [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(5, 30)))), max_new_tokens=8,
        arrival=i) for i in range(6)]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = PagedServeEngine(cfg, _to(cpu, dev), max_slots=3, max_len=48,
                               page_size=4, prefill_chunk=8, decode_block=2,
                               device=dev)
        tokens[dev] = {c.rid: c.tokens for c in eng.run(reqs)}
    check(tokens["cpu"] == tokens["cuda"], f"reduced musicgen_large: card "
          f"and CPU paged tokens differ: {tokens}")
    print("[reference] reduced musicgen_large (paged): card tokens == CPU "
          "plain-path tokens")


def moe_rwkv_models_agree(torch, rng) -> None:
    """The reduced Qwen3-MoE (dropless) through ``PagedServeEngine``
    (kernel A on every layer) and the reduced RWKV6 through the lockstep
    path, float32 activations, on the card and on the CPU (plain
    versions): equal greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import PagedServeEngine, Request
    from repro_torch.launch.serve import build_generate_fn, build_prefill_step
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen3_moe_30b_a3b", reduced=True),
                              activation_dtype=torch.float32)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    reqs = [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(5, 30)))), max_new_tokens=8,
        arrival=i) for i in range(6)]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = PagedServeEngine(cfg, _to(cpu, dev), max_slots=3, max_len=48,
                               page_size=4, prefill_chunk=8, decode_block=2,
                               device=dev)
        tokens[dev] = {c.rid: c.tokens for c in eng.run(reqs)}
    check(tokens["cpu"] == tokens["cuda"], f"reduced qwen3_moe_30b_a3b: card "
          f"and CPU paged tokens differ: {tokens}")
    print("[reference] reduced qwen3_moe_30b_a3b (paged): card tokens == "
          "CPU plain-path tokens")
    cfg = dataclasses.replace(get_config("rwkv6_3b", reduced=True),
                              activation_dtype=torch.float32)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 150)),
                              dtype=torch.int32)
    gen = {}
    for dev in ("cpu", "cuda"):
        p = lm.serving_params(_to(cpu, dev), cfg)
        cache = lm.init_model_cache(cfg, 2, 160, device=dev)
        last, cache = build_prefill_step(cfg)(p, cache, prompts.to(dev))
        gen[dev] = build_generate_fn(cfg, 8)(
            p, cache, torch.argmax(last, -1).to(torch.int32), 150)[0].cpu()
    check(torch.equal(gen["cpu"], gen["cuda"]), f"reduced rwkv6_3b: card "
          f"and CPU lockstep tokens differ: {gen}")
    print("[reference] reduced rwkv6_3b (lockstep): card tokens == CPU "
          "plain-path tokens")


def windowed_models_agree(torch, rng) -> None:
    """The reduced Gemma3 and RecurrentGemma (float32 activations, window
    16) through the lockstep path on the card and on the CPU (plain
    versions): a 2 x 40-token prefill (the band on the local layers,
    kernel F on Gemma3's global layer) and 6 decode steps over the
    wrapping rings, ``OFF`` logits within ``WINDOWED_TOL``; and on the
    card, ``decode_step`` logits against the whole-sequence ``forward``
    within the same tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_prefill_step
    from repro_torch.models import lm
    for name in ("gemma3_27b", "recurrentgemma_9b"):
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  activation_dtype=torch.float32)
        cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(
            SEED), device="cpu")
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 46)),
                               dtype=torch.int32)
        logits = {}
        for dev in ("cpu", "cuda"):
            p = lm.serving_params(_to(cpu, dev), cfg)
            cache = lm.init_model_cache(cfg, 2, 48, device=dev)
            out = [build_prefill_step(cfg)(p, cache, toks[:, :40].to(dev))[0]]
            for t in range(40, 46):
                out.append(lm.decode_step(p, cfg, toks[:, t].to(dev), t,
                                          cache))
            logits[dev] = torch.stack([o.cpu() for o in out])
        err = (logits["cpu"] - logits["cuda"]).abs().max().item()
        check(err <= WINDOWED_TOL, f"reduced {name}: card vs CPU OFF logits "
              f"{err} > {WINDOWED_TOL}")
        full = lm.forward(p, toks.to("cuda"), cfg, mode="train")
        cache = lm.init_model_cache(cfg, 2, 48, device="cuda")
        steps = torch.stack([lm.decode_step(p, cfg, toks[:, t].to("cuda"), t,
                                            cache) for t in range(46)], 1)
        step_err = (steps - full).abs().max().item()
        check(step_err <= WINDOWED_TOL, f"reduced {name}: decode_step vs "
              f"forward on the card {step_err} > {WINDOWED_TOL}")
        print(f"[reference] reduced {name}: card vs CPU OFF logits max "
              f"|diff| {err:.3g}; decode_step vs forward on the card "
              f"{step_err:.3g} (tolerance {WINDOWED_TOL})")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def zero_counts() -> None:
    """Every kernel count to 0 (kernel A's per-pool-kind counts too)."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    for fn in counters():
        fn.launches = 0
    for kind in paged_attention.pool_launches:
        paged_attention.pool_launches[kind] = 0


def pool_bytes(cache: dict) -> int:
    """Bytes of a paged cache's pools (codes and scales alike)."""
    from repro_torch.models.lm import POOL_LEAVES
    return sum(cache[n].numel() * cache[n].element_size()
               for n in POOL_LEAVES if n in cache)


def counters() -> list:
    """The kernel wrappers, each counting its launches."""
    from repro_torch.kernels.acam_activation.ops import acam_apply
    from repro_torch.kernels.crossbar_vmm.ops import crossbar_vmm
    from repro_torch.kernels.dual_compute.ops import (
        fused_crossbar_acam, log_quantize_qkv, logdomain_flash_attention)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.nldpe_qmatmul.ops import nldpe_qmatmul
    from repro_torch.kernels.paged_attention.ops import paged_attention
    return [paged_attention, fused_crossbar_acam, flash_attention,
            logdomain_flash_attention, log_quantize_qkv, acam_apply,
            crossbar_vmm, nldpe_qmatmul]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs on the GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             f"(src/repro_torch missing)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.drift import DriftModel
    from repro_torch.core.engine import FUSED, OFF, ON, NLDPEConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.dual_compute.ops import (
        fused_crossbar_acam, log_quantize_qkv, logdomain_flash_attention)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.engine import PagedServeEngine, ServeEngine
    from repro_torch.launch.fidelity import DriftInjection, FidelityPolicy
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(logs)} kernel sources compiled in "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = cut_config("qwen2_5_3b", SERVE_LAYERS)
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    print(f"[setup] {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters "
          f"(float32) in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    paged_kw = dict(max_slots=8, max_len=1024, nldpe=OFF, page_size=16,
                    prefill_chunk=64, decode_block=4)
    off = PagedServeEngine(cfg, params, **paged_kw)
    off_res = serve(torch, off, make_trace(cfg, 8, 32, 0), paged_attention,
                    "serve OFF")
    profile_window(torch, off, make_trace(cfg, 4, 32, 0), "serve OFF")
    # each serve phase's peak memory holds one engine: keep only what the
    # kernel phase reads
    off_in, off_bytes = kernel_a_inputs(off), pool_bytes(off.cache)
    del off
    torch.cuda.empty_cache()
    print(f"[serve OFF] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    tele = PagedServeEngine(cfg, params, telemetry=True, **paged_kw)
    tele_res = serve_telemetry(torch, tele, make_trace(cfg, 8, 32, 0),
                               off_res, "serve telemetry")
    # the non-spec tokens [serve spec drift] is held against (64 new)
    drift_want = reference_tokens(tele, make_trace(cfg, 8, 64, 0))
    route = tele_res["route"]
    del tele
    torch.cuda.empty_cache()
    print(f"[serve telemetry] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    spill_res = serve_spill(torch, cfg, params, paged_kw, route)
    print(f"[serve spill] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    preempt_res = serve_preempt(torch, cfg, params, paged_kw, route)
    print(f"[serve preempt] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    async_res = serve_async(torch, cfg, params, paged_kw, off_res, route)
    print(f"[serve async] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log8 = PagedServeEngine(cfg, params, max_slots=8, max_len=1024,
                            nldpe=OFF, page_size=16, prefill_chunk=64,
                            decode_block=4, kv_quant="log8")
    log8_res = serve_log8(torch, log8, off_bytes, make_trace(cfg, 8, 32, 0))
    # a 2-request window (4 before the tier phases came), for their time
    profile_window(torch, log8, make_trace(cfg, 2, 32, 0), "serve OFF log8")
    log8_in = kernel_a_inputs(log8)
    del log8
    torch.cuda.empty_cache()
    print(f"[serve OFF log8] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fused = PagedServeEngine(cfg, params, max_slots=8, max_len=1024,
                             nldpe=FUSED, page_size=16, prefill_chunk=64,
                             decode_block=4)
    fused_res = serve(torch, fused, make_trace(cfg, 4, 16, 0),
                      fused_crossbar_acam, "serve FUSED")
    profile_window(torch, fused, make_trace(cfg, 2, 16, 0), "serve FUSED")
    del fused
    print(f"[serve FUSED] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    spec2 = PagedServeEngine(cfg, params, spec_k=2,
                             spec_draft=NLDPEConfig(enabled=False),
                             **paged_kw)
    spec2_tokens = reference_tokens(spec2, make_trace(cfg, 4, 16, 0))
    del spec2
    torch.cuda.empty_cache()
    mesh_res = serve_mesh_phase(
        torch, cfg, params, {"OFF": off_res["tokens"],
                             "FUSED": fused_res["tokens"],
                             "spec2": spec2_tokens})
    print(f"[serve mesh] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train_mesh_phase(torch)
    print(f"[train mesh] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cut_cfg, cut_params = cut_depth(cfg, params, CUT_LAYERS)
    lock_off = lockstep(torch, cut_cfg, cut_params, OFF, batch=8,
                        prompt_len=512,
                        gen_len=32, counters_on_path=[flash_attention],
                        label="serve lockstep OFF", compare_loop=True)
    print(f"[serve lockstep OFF] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lock_fused = lockstep(torch, cut_cfg, cut_params, FUSED, batch=4,
                          prompt_len=256, gen_len=8, counters_on_path=[
                              logdomain_flash_attention, log_quantize_qkv,
                              fused_crossbar_acam],
                          label="serve lockstep FUSED", compare_loop=False)
    print(f"[serve lockstep FUSED] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    slotted = ServeEngine(cut_cfg, cut_params, max_slots=8, max_len=1024,
                          nldpe=OFF, prefill_chunk=64, decode_block=4)
    # 4 requests and a 2-request window (8 and 4 before the tier phases
    # came), for their time
    serve(torch, slotted, make_trace(cfg, 4, 32, 0), None,
          "serve slotted OFF")
    profile_window(torch, slotted, make_trace(cfg, 2, 32, 0),
                   "serve slotted OFF")
    del slotted
    torch.cuda.empty_cache()
    print(f"[serve slotted OFF] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    spec = PagedServeEngine(cfg, params, spec_k=4,
                            spec_draft=NLDPEConfig(enabled=False),
                            **paged_kw)
    spec_res = serve_spec(torch, spec, make_trace(cfg, 8, 32, 0), off_res,
                          "serve spec")
    profile_window(torch, spec, make_trace(cfg, 4, 16, 0), "serve spec")
    del spec
    torch.cuda.empty_cache()
    print(f"[serve spec] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    analog = PagedServeEngine(cfg, params, spec_k=1, spec_draft=ON,
                              **paged_kw)
    analog_res = serve_spec(torch, analog, make_trace(cfg, 4, 16, 0),
                            off_res, "serve spec analog")
    profile_window(torch, analog, make_trace(cfg, 2, 16, 0),
                   "serve spec analog")
    del analog
    torch.cuda.empty_cache()
    print(f"[serve spec analog] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    aging = PagedServeEngine(
        cfg, params, spec_k=4, spec_draft=NLDPEConfig(enabled=False),
        drift=DriftInjection(DriftModel(nu=DRIFT_NU, t0=DRIFT_T0,
                                        fault_rate=DRIFT_FAULT_RATE),
                             seed=SEED, dt_step=DRIFT_DT,
                             reprogram_s=DRIFT_REPROGRAM_S),
        fidelity=FidelityPolicy(**DRIFT_POLICY), telemetry=True, **paged_kw)
    print(f"[serve spec drift] engine built in "
          f"{time.perf_counter() - t0:.1f} s (programming "
          f"{aging.drift_program_seconds:.2f} s), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    drift_res = serve_spec_drift(torch, aging, make_trace(cfg, 8, 64, 0),
                                 drift_want, "serve spec drift")
    profile_window(torch, aging, make_trace(cfg, 4, 16, 0),
                   "serve spec drift")
    del aging
    torch.cuda.empty_cache()
    print(f"[serve spec drift] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gemma3 = gemma3_phase(torch, Timer(torch))
    print(f"[gemma3] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rgemma = recurrentgemma_phase(torch, Timer(torch))
    print(f"[recurrentgemma] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    qmoe = qwen3moe_phase(torch, Timer(torch))
    print(f"[qwen3moe] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rwkv6_phase(torch)
    print(f"[rwkv6] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pali = paligemma_phase(torch, Timer(torch))
    print(f"[paligemma] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    music = musicgen_phase(torch, Timer(torch))
    print(f"[musicgen] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lib = library_phase(torch, params)
    library_checks(torch, lib)
    print(f"[library] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cnn_res = cnn_phase(torch)
    print(f"[cnn] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    timer = Timer(torch)
    kernels = [
        paged_attention_phase(
            torch, timer, off_in, path_launches(off_res, "paged_attention"),
            log8_in, log8_res, {
                "launches_serve_spec": spec_res["launches"][
                    "paged_attention"],
                "launches_serve_spec_per_tick": spec_res[
                    "paged_attention_per_tick_by_shape"],
                "launches_serve_spec_analog": analog_res["launches"][
                    "paged_attention"],
                "launches_serve_spec_analog_per_tick": analog_res[
                    "paged_attention_per_tick_by_shape"],
                "launches_serve_spec_drift": drift_res["launches"][
                    "paged_attention"],
                "launches_serve_spec_drift_by_shape": drift_res[
                    "paged_attention_by_shape"],
                "launches_serve_spill": spill_res["launches"][
                    "paged_attention"],
                "launches_serve_spill_destroy_twin": spill_res[
                    "twin_launches"]["paged_attention"],
                "launches_serve_preempt": preempt_res["launches"][
                    "paged_attention"],
                "launches_serve_async": async_res["launches"][
                    "paged_attention"],
                "launches_qwen3moe": qmoe["launches"]["paged_attention"],
                "launches_paligemma": pali["launches"]["paged_attention"],
                "launches_musicgen": music["launches"]["paged_attention"],
                "launches_serve_mesh_per_shard": mesh_launches(
                    mesh_res, "paged_attention")},
            qmoe["kernel_cases"]["paged_attention"]
            + pali["kernel_cases"]["paged_attention"]
            + music["kernel_cases"]["paged_attention"]),
        fused_acam_phase(torch, timer, params, {
            **path_launches(fused_res, "fused_crossbar_acam"),
            "launches_gemma3": gemma3["launches"]["fused_crossbar_acam"],
            "launches_recurrentgemma": rgemma["launches"][
                "fused_crossbar_acam"],
            "launches_paligemma": pali["launches"]["fused_crossbar_acam"],
            "launches_musicgen": music["launches"]["fused_crossbar_acam"],
            "launches_serve_mesh_per_shard": mesh_launches(
                mesh_res, "fused_crossbar_acam")},
            gemma3["kernel_cases"]["fused_crossbar_acam"]
            + rgemma["kernel_cases"]["fused_crossbar_acam"]
            + pali["kernel_cases"]["fused_crossbar_acam"]
            + music["kernel_cases"]["fused_crossbar_acam"]),
        logdomain_phase(torch, timer, {
            **lock_fused["per_kernel"]["logdomain_flash_attention"],
            "launches_gemma3": gemma3["launches"][
                "logdomain_flash_attention"],
            "launches_qwen3moe": qmoe["launches"][
                "logdomain_flash_attention"],
            "launches_paligemma": pali["launches"][
                "logdomain_flash_attention"],
            "launches_musicgen": music["launches"][
                "logdomain_flash_attention"]},
            gemma3["kernel_cases"]["logdomain_flash_attention"]
            + qmoe["kernel_cases"]["logdomain_flash_attention"]
            + pali["kernel_cases"]["logdomain_flash_attention"]
            + music["kernel_cases"]["logdomain_flash_attention"]),
        acam_phase(torch, timer, lib),
        crossbar_phase(torch, timer, lib),
        flash_phase(torch, timer, {
            **lock_off["per_kernel"]["flash_attention"],
            "launches_gemma3": gemma3["launches"]["flash_attention"],
            "launches_qwen3moe": qmoe["launches"]["flash_attention"],
            "launches_recurrentgemma": rgemma["launches"][
                "flash_attention"],
            "launches_paligemma": pali["launches"]["flash_attention"],
            "launches_musicgen": music["launches"]["flash_attention"]},
            gemma3["kernel_cases"]["flash_attention"]
            + qmoe["kernel_cases"]["flash_attention"]
            + rgemma["kernel_cases"]["flash_attention"]
            + pali["kernel_cases"]["flash_attention"]
            + music["kernel_cases"]["flash_attention"]),
        qmatmul_phase(torch, timer, lib, cnn_res)]
    del lib, off_in, log8_in, cnn_res
    print(f"[kernels] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    small_model_agrees(torch)
    print(f"[reference] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    naf_dt = naf_dt_phase(torch, timer)
    print(f"[naf dt] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pipeline = naf_pipeline_phase(torch)
    print(f"[naf pipeline] phase {time.perf_counter() - t0:.1f} s")
    d_entry = next(k for k in kernels if k["name"] == "acam_apply")
    d_entry["launches_naf_dt"] = naf_dt["kernel_d_launches"]
    d_entry["launches_naf_pipeline"] = pipeline["kernel_d_launches"]
    d_entry["naf_dt_ms_per_evaluation"] = naf_dt["kernel_d_ms_per_evaluation"]

    t0 = time.perf_counter()
    train_ckpt_phase(torch)
    print(f"[train ckpt] phase {time.perf_counter() - t0:.1f} s")

    # last: it updates the float32 masters in place
    t0 = time.perf_counter()
    train_phase(torch, cut_cfg, cut_params)
    print(f"[train] phase {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
