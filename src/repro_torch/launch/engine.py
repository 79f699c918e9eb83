"""Continuous-batching serve engines (port of ``repro.launch.engine``'s
``ServeEngine`` and ``PagedServeEngine``).

* **Slots** — ``max_slots`` independent sequences share one batch.
  ``ServeEngine`` gives each a row of a slotted dense cache
  (``lm.init_model_cache(..., slotted=True)``; windowed layers keep rings
  of ``window + prefill_chunk - 1`` lines, so it serves Gemma3's
  local:global pattern; recurrent and RWKV6 blocks are refused, as in
  ``repro``);
  ``PagedServeEngine`` (attention without windows) maps a
  slot's logical blocks onto physical pages of a per-layer pool through its
  block-table row (``launch/kvpool.py`` owns the page metadata).
* **Admission** — a wave of requests takes free slots and is prefilled in
  fixed ``(max_slots, prefill_chunk)`` chunks at per-slot base positions
  (chunk attention over the whole per-slot cache under validity masking).
  The paged engine first plans the wave onto pages (radix hits mapped
  read-only, a fully covered prompt forks its boundary page
  copy-on-write, the rest allocated, evicting LRU cache if needed),
  publishes it, and prefills only the prompt *suffix*.
* **Decode** — each tick runs ``decode_block`` steps over all slots; a
  per-slot write mask freezes finished and empty slots.  ``_dispatch_tick``
  issues the device work and ``_harvest`` folds the emitted tokens into the
  requests on the host.
* **Sampling** — per-slot greedy / temperature / top-k keyed on (request
  seed, position), independent of slot placement (``launch/sampling.py``).

``PagedServeEngine`` subclasses ``ServeEngine``, as in ``repro``: the
scheduler exists once and the subclass swaps the cache layout, wave
selection (page budget) and slot release (page references, prefix
publication).

* **KV storage grid** — ``kv_quant="int8"``/``"log8"`` (or a config whose
  ``kv_cache_dtype`` names the grid) stores 8-bit codes with per-(position,
  head) scales (DESIGN.md §11); the paged engine keys its radix root on the
  grid.
* **Speculative decoding** — ``PagedServeEngine(spec_k=K)``: each tick
  drafts K tokens per slot through the NL-DPE drafter and verifies them in
  one exact chunk (``launch/spec_decode.py``, DESIGN.md §8).
* **Closed-loop fidelity** — ``PagedServeEngine(spec_k=K, drift=...,
  fidelity=...)``: the drafter's cells drift and stick on a virtual clock
  (``core/drift.py``) and a monitor walks the degradation ladder on the
  live acceptance — back off spec_k, reprogram, disable the draft path
  (``launch/fidelity.py``, DESIGN.md §10).
* **Telemetry** — ``telemetry=True`` (or a ``Telemetry``) on either engine:
  per-request TTFT/TPOT/queue wait, phase walls and a schema-checked event
  trace (``obs/``, DESIGN.md §12), host-side observation only; the
  ``metrics`` registry is always on.

* **Host spill tier** — ``PagedServeEngine(host_cache_pages=N)``: LRU
  eviction demotes refcount-0 radix pages to host memory instead of
  destroying them, and a radix hit on a spilled chain restores it
  host->device before publish (DESIGN.md §13, ``launch/kvpool.py``).
* **Priority preemption** — ``Request.priority``: higher classes admit
  first, and a strictly higher arrival may swap a running lower-priority
  slot out to host memory (its decode state, position row and every page's
  bytes); the victim resumes later, indistinguishable from never having
  been preempted.
* **Prefill buckets** — ``prefill_buckets=True`` (or an iterable of chunk
  counts) on either engine rounds each admission wave's chunk count up to
  a bucket, the pad chunks write-masked off.  Eager PyTorch has nothing to
  compile ahead, so the buckets are pad-only, as ``repro``'s are under a
  mesh (``aot_prefill`` is False).
* **Async serving** — ``launch/async_engine.AsyncServeEngine`` runs
  ``_dispatch_tick`` and ``_harvest`` on separate threads (DESIGN.md §14).
* **MoE** — both engines serve the ``moe`` pattern (Qwen3-MoE,
  Llama4-Scout) in every numerics mode, pool grid and spec setting, each
  forward's tokens one routing group.  Under a capacity factor an
  assignment may drop, and which ones do depends on the tokens batched
  together (padding rows of a chunk included), as in ``repro``;
  ``moe_stats`` (the ``"moe"`` metrics group) counts the dropped
  assignments of the prefill chunks and of the plain decode steps (a spec
  tick's draft and verify forwards are not counted).

* **Meshes** — ``mesh=`` (a ``parallel.context.Mesh``, one per rank:
  ``launch/mesh.py``) and ``rules=`` (a ``Rules`` table or the name of
  one of ``sharding.SERVE_TABLES``, default ``"serve_exact"``) on either
  engine: every parameter and cache leaf is held as this rank's shard of
  the placement the rules give it (``nn.module.spec_tree``, ``lm.cache_pspecs``), and
  the model runs under the sharding context (heads and FFN columns over
  "model", kernel A and B once per shard, slots over "data").  Every rank
  runs the same host scheduling on the same trace — admission,
  radix/COW/eviction, spec rollback stay global —, each samples its own
  slots, and the sampled tokens are all-gathered, so every rank's
  scheduler sees every token.  Under the exact tables sharded serving
  equals single-device serving token for token.  Under ``serve`` the
  output and down projections sum partial products over "model" (an
  all-reduce in float32) and the vocab is split (a vocab-parallel
  lookup; the logits are gathered whole before sampling, exactly), so
  tokens equal single-device tokens up to near-ties.  ``serve_dshard``,
  ``long``, a cache whose positions the placement splits ("kv_seq"),
  drift injection and the async pipeline under a mesh are ROADMAP.md
  A.2's queue and raise ``NotImplementedError``.

Where ``repro`` donates device buffers to its jitted steps, these engines
update the cache and the decode state in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref
from collections import deque

import numpy as np
import torch

from .. import resolve_device
from ..core import drift as drift_lib
from ..core.engine import NLDPEConfig, OFF
from ..core.logdomain import log_quantize
from ..models import lm
from ..nn import attention
from ..nn.module import shard_tree, spec_tree
from ..obs import MetricsRegistry, Telemetry
from ..parallel import sharding
from ..parallel.context import sharding_ctx
from . import prng
from .fidelity import DriftInjection, FidelityMonitor, FidelityPolicy
from .kvpool import PagePool, nldpe_fingerprint
from .sampling import TOP_K_CAP, request_key, sample_tokens, step_keys
from .spec_decode import (build_draft_scan_fn, build_verify_fn,
                          clip_positions, emits_tick_major,
                          quantize_draft_params)

@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request entering the scheduler."""

    rid: int
    tokens: tuple[int, ...]            # prompt token ids, length >= 1
    max_new_tokens: int = 16           # total generated tokens (incl. first)
    temperature: float = 0.0           # 0 -> greedy; finite, >= 0
    top_k: int = 0                     # 0 -> disabled
    seed: int | None = None            # defaults to rid
    arrival: int = 0                   # arrival time in decode ticks
    priority: int = 0                  # higher admits first; strictly
    #                                    higher may preempt (paged engine)


@dataclasses.dataclass
class Completion:
    """Scheduler output for one finished request."""

    rid: int
    prompt: tuple[int, ...]
    tokens: list[int]                  # generated tokens, length <= max_new
    finish_reason: str                 # "length" | "eos"
    admitted_tick: int
    finished_tick: int


@dataclasses.dataclass
class _Preempted:
    """A preempted request's whole resume image on the host: its decode
    state, sampling key, position-track row and every block-table page's
    bytes (real copies: the cache is written in place, and the next chunk
    or decode may overwrite the released pages).  Sampling folds (seed,
    position), drafts are deterministic per prefix, and attention reaches
    page bytes only through the block table, so resuming into other
    physical pages changes no token."""

    req: Request
    tok: int
    pos: int
    gen_left: int
    temp: float
    topk: int
    keys: np.ndarray                   # (2,) int64 sampling key
    pos_row: torch.Tensor              # (max_len,) int32 position track
    payloads: list                     # per page, the pool leaves' rows
    tel_carry: tuple                   # (drafted, accepted) already done


class ServeEngine:
    """Continuous batching over a slotted dense KV cache.

    Drive it with :meth:`run` (serve a whole trace, returns completions
    sorted by rid).  ``params`` is the float32 parameter tree of
    ``models.lm.init_params`` (or ``convert.from_jax``) on ``device`` — the
    card unless ``device="cpu"``.  ``kv_quant`` selects the KV storage grid
    ("int8", "log8", or None to keep ``cfg.kv_cache_dtype``); it is carried
    on the config, so setting it is ``dataclasses.replace(cfg,
    kv_cache_dtype=kv_quant)``.

    ``telemetry=True`` (or a :class:`~repro_torch.obs.Telemetry`) records
    the per-request lifecycle, phase walls and the event trace; every call
    site is host-side observation at a boundary the engine already
    synchronizes, so tokens are the same with it on or off.  ``metrics``
    (always on) is the registry of lazy stats groups: ``"engine"``, and
    ``"latency"`` with telemetry.

    ``prefill_buckets`` (True, or an iterable of chunk counts) rounds each
    admission wave's chunk count up to a bucket (``_bucket_table``); the
    pad chunks are write-masked off, so tokens and cache bytes do not
    change, and ``prefill_pad_chunks`` counts them.

    ``batch_groups`` splits each MoE layer's tokens into that many routing
    groups (``nn.moe.moe_apply``; under "data" they follow the slot
    split).  ``mesh``/``rules``: the module docstring; ``params`` is then
    the whole tree on every rank, and the engine keeps this rank's shard.
    """

    def __init__(self, cfg, params, *, max_slots: int, max_len: int,
                 nldpe: NLDPEConfig = OFF, prefill_chunk: int = 16,
                 decode_block: int = 4, eos_id: int = -1,
                 batch_groups: int = 1,
                 dtype=torch.float32, kv_quant: str | None = None,
                 mesh=None, rules=None,
                 device=None, telemetry: Telemetry | bool | None = None,
                 prefill_buckets=None):
        bad = [t for t in cfg.layer_pattern if t not in lm.ATTN_TYPES]
        if bad:
            raise NotImplementedError(
                f"continuous batching needs attention-block caches; "
                f"{cfg.name} pattern has {bad}")
        if prefill_chunk < 1 or decode_block < 1 or max_slots < 1:
            raise ValueError("max_slots, prefill_chunk, decode_block >= 1")
        if kv_quant not in (None, "int8", "log8"):
            raise ValueError('kv_quant must be None, "int8", or "log8"')
        if kv_quant is not None:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_quant)
        self.kv_quant = lm.kv_quant_of(cfg)
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        if params["embed"]["table"].device.type != self.device.type:
            raise ValueError(f"params live on "
                             f"{params['embed']['table'].device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.nldpe = nldpe
        if batch_groups < 1:
            raise ValueError("batch_groups >= 1")
        self.batch_groups = batch_groups
        self.max_slots = max_slots
        self._set_mesh(mesh, rules)
        self.params = self._place_params(
            lm.serving_params(params, cfg, nldpe))
        self.max_len = max_len
        self.prefill_chunk = min(prefill_chunk, max_len)
        self.decode_block = decode_block
        self.eos_id = eos_id
        self.dtype = dtype
        self.cache = self._place_cache(self._init_cache())
        # MoE: dropped assignments (device counters, read by moe_stats:
        # live tokens' at 0, padding rows' at 1) and the forwards they
        # were counted over
        self._moe_drops = ({k: torch.zeros((2,), dtype=torch.int64,
                                           device=self.device)
                            for k in ("prefill", "decode")}
                           if "moe" in cfg.layer_pattern else None)
        self._moe_forwards = {"prefill": 0, "decode": 0}

        s, dev = max_slots, self.device
        self._tok = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._gen_left = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._temp = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._keys = torch.zeros((s, 2), dtype=torch.int64, device=dev)

        self._slot_owner: list[Request | None] = [None] * s
        self._free = deque(range(s))
        self._out: dict[int, list[int]] = {}
        self._admitted_tick: dict[int, int] = {}
        # requests swapped out to the host by priority preemption (the paged
        # engine fills it; the run loop only has to know they exist)
        self._preempted: list[_Preempted] = []
        self.tick = 0
        # pad-only prefill buckets: the ladder of chunk counts a wave's
        # prefill rounds up to (empty: run exactly the wave's chunks)
        self._bucket_sizes = (self._bucket_table(prefill_buckets)
                              if prefill_buckets else [])
        self.prefill_pad_chunks = 0
        self.aot_prefill = False
        # host-clock totals (each region ends in a device->host copy, so
        # the device work inside it has finished)
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.decode_ticks = 0

        # observability (DESIGN.md §12): the registry's groups are lazy
        # closures over state the engine keeps anyway; event and latency
        # telemetry is opt-in and every call site is guarded on it
        if telemetry is True:
            telemetry = Telemetry()
        elif telemetry is False:
            telemetry = None
        self.telemetry = telemetry
        # rid -> (slot, drafted-at-admit, accepted-at-admit): finish
        # attributes per-request spec acceptance from the slot counters
        self._tel_admit: dict[int, tuple[int, int, int]] = {}
        self.metrics = MetricsRegistry()
        # the registry's groups (and the paged pool's eviction hook) reach
        # the engine through a weak reference: a cycle through them would
        # keep a dropped engine's device memory until the cyclic collector
        # ran
        me = weakref.ref(self)
        self.metrics.register_group("engine", lambda: me()._engine_stats())
        if self._moe_drops is not None:
            self.metrics.register_group("moe", lambda: me().moe_stats)
        if self.telemetry is not None:
            self.metrics.register_group("latency", self.telemetry.summary)

    def _cache_layout(self) -> dict:
        # windowed rings get prefill_chunk - 1 slack lines: a chunk's
        # writes land before its queries attend, so the chunk's first query
        # still needs the full window behind it (nn.attention.cache_length)
        return dict(slotted=True, ring_slack=self.prefill_chunk - 1)

    def _init_cache(self) -> dict:
        return lm.init_model_cache(self.cfg, self.max_slots, self.max_len,
                                   dtype=self.dtype, device=self.device,
                                   **self._cache_layout())

    # ------------------------------------------------------------------
    # mesh placement (no-ops without a mesh)
    # ------------------------------------------------------------------

    def _set_mesh(self, mesh, rules) -> None:
        """Keep the mesh and its rule table, and find the slots this rank
        holds (``_rows``: a contiguous block when the slots split over
        the rules' "slots" axes, all of them otherwise)."""
        self.mesh = mesh
        if isinstance(rules, str):
            rules = sharding.serving_rules(rules)
        self.rules = rules if rules is not None \
            else sharding.serve_exact_rules()
        self._rows = slice(0, self.max_slots)
        self._row_axes: tuple = ()
        if mesh is None:
            return
        if self.rules.name in sharding.NOT_SERVED:
            raise NotImplementedError(
                f"rule table {self.rules.name!r}: "
                f"{sharding.NOT_SERVED[self.rules.name]}")
        s = self.max_slots
        by = {n: sharding.resolve(self.rules, (n,), (s,), mesh).axes_of(0)
              for n in ("slots", "batch")}
        if by["slots"] != by["batch"]:
            raise NotImplementedError(
                f"rule table {self.rules.name!r} splits slots over "
                f"{by['slots']} but batch rows over {by['batch']}")
        self._row_axes = by["slots"]
        if self._row_axes:
            n, idx = 1, 0
            for ax in self._row_axes:
                n *= mesh.shape[ax]
                idx = idx * mesh.shape[ax] + mesh.coords[ax]
            self._rows = slice(idx * s // n, (idx + 1) * s // n)

    def _sharded(self):
        """The sharding context the model runs under (none without a
        mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding_ctx(self.mesh, self.rules, batch=self.max_slots)

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slots of a per-slot tensor (S, ...)."""
        return x if not self._row_axes else x[self._rows]

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's slots of a per-slot tensor, in slot order."""
        if not self._row_axes:
            return x
        return self.mesh.all_gather(x, 0, self._row_axes)

    def _place_params(self, params: dict) -> dict:
        """This rank's shard of every parameter leaf, per the rule table
        (``nn.module.spec_tree``)."""
        if self.mesh is None:
            return params
        return shard_tree(params, spec_tree(params, self.cfg, self.mesh,
                                            self.rules), self.mesh)

    def _place_cache(self, cache: dict) -> dict:
        """This rank's shard of every cache leaf (``lm.cache_pspecs``):
        kv heads over "model", slots over "data", pages replicated."""
        if self.mesh is None:
            return cache
        specs = lm.cache_pspecs(self.cfg, self.max_slots, self.max_len,
                                self.mesh, self.rules,
                                **self._cache_layout())
        for name, st in (("full", specs), ("ring", specs.get("ring", {}))):
            if "k" in st and st["k"].axes_of(3):
                raise NotImplementedError(
                    f"rule table {self.rules.name!r} splits the {name} "
                    f"stack's cache positions over {st['k'].axes_of(3)} "
                    f"(\"kv_seq\": {self.cfg.n_kv_heads} kv heads do not "
                    f"divide \"model\"): context-parallel paged decode is "
                    f"ROADMAP.md A.2 queue, item 2")
        return shard_tree(cache, specs, self.mesh)

    def _full(self) -> dict:
        """The full-length attention stack of the cache (pools, position
        track, block table)."""
        return lm.stacks(self.cache)["full"]

    def _slot_track(self, name: str, sl: int) -> torch.Tensor:
        """Slot ``sl``'s row of the full stack's per-slot leaf ``name``
        ("pos", "bt"), from whichever rank holds it (every rank calls
        this: the scheduler runs on all of them)."""
        return self._gather(self._full()[name])[sl]

    def _set_slot_track(self, name: str, sl: int, row) -> None:
        """Write slot ``sl``'s row of ``name`` on the rank that holds
        it."""
        if self._rows.start <= sl < self._rows.stop:
            self._full()[name][sl - self._rows.start] = row

    def _bucket_table(self, spec) -> list[int]:
        """The prefill bucket ladder (``repro``'s ``_build_buckets``):
        ``spec`` True gives the powers of two below ceil(max_len /
        prefill_chunk) and that maximum; an iterable of chunk counts is
        sorted, clamped to [1, maximum] and closed with the maximum, so
        every wave fits a bucket."""
        n_max = -(-self.max_len // self.prefill_chunk)
        if spec is True:
            sizes, n = [], 1
            while n < n_max:
                sizes.append(n)
                n *= 2
            sizes.append(n_max)
            return sizes
        sizes = sorted({min(max(1, int(b)), n_max) for b in spec})
        if not sizes or sizes[-1] != n_max:
            sizes.append(n_max)
        return sizes

    # ------------------------------------------------------------------
    # device helpers
    # ------------------------------------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _chunk(self, tokens, base_pos, mask, limit) -> torch.Tensor:
        """One (max_slots, prefill_chunk) suffix-prefill chunk at per-slot
        base positions (under a mesh, this rank's slots and, where the
        rules split the vocab, its vocab columns: the logits are theirs;
        the caller gathers the positions it samples).  Pre-clear: stale
        entries >= base on writing slots become never-valid before the
        chunk attends; post-clip: entries >= limit (= min(prompt length,
        chunk end)) trim the padded tail."""
        c = self.prefill_chunk
        tokens, base_pos, mask, limit = (self._local(t) for t in
                                         (tokens, base_pos, mask, limit))
        clip_positions(self.cache, mask, base_pos)
        positions = base_pos[:, None] + torch.arange(
            c, dtype=torch.int32, device=self.device)
        with self._sharded():
            logits = lm.forward(self.params, tokens, self.cfg,
                                cache=self.cache, positions=positions,
                                nldpe=self.nldpe, write_mask=mask,
                                moe_drops=self._moe_count("prefill"),
                                moe_live=mask[:, None]
                                & (positions < limit[:, None]),
                                batch_groups=self.batch_groups,
                                gather_vocab=False)
        clip_positions(self.cache, mask, limit)
        return logits

    def _moe_count(self, kind: str) -> torch.Tensor | None:
        """The dropped-assignment counter a forward of ``kind`` adds to
        (None without MoE layers), counting the forward."""
        if self._moe_drops is None:
            return None
        self._moe_forwards[kind] += 1
        return self._moe_drops[kind]

    @property
    def moe_stats(self) -> dict:
        """MoE assignments dropped for capacity in the prefill chunks and
        in the plain decode steps, in all and per forward (every MoE layer
        of one forward together): those of live tokens (a request's prompt
        or decode tokens) and, as ``dropped_pad_*``, those of padding rows
        (idle or finished slots, a chunk's tail past the prompt), whose
        outputs are discarded.  Reading it synchronizes the device (and,
        with slots split over ranks, sums the ranks' counts)."""
        if self._moe_drops is None:
            return {}
        out = {}
        for kind, t in self._moe_drops.items():
            if self._row_axes:
                t = self.mesh.all_reduce(t, self._row_axes)
            (n, pad), calls = t.tolist(), self._moe_forwards[kind]
            out.update({f"dropped_{kind}": n, f"dropped_pad_{kind}": pad,
                        f"{kind}_forwards": calls,
                        f"dropped_per_{kind}_forward": n / max(calls, 1),
                        f"dropped_pad_per_{kind}_forward":
                            pad / max(calls, 1)})
        return out

    def reset_moe_stats(self) -> None:
        """Zero ``moe_stats``."""
        if self._moe_drops is not None:
            for t in self._moe_drops.values():
                t.zero_()
            self._moe_forwards = {"prefill": 0, "decode": 0}

    def _merge_state(self, sel: np.ndarray, tok, pos, gen, temp, topk,
                     keys) -> None:
        """Write admitted slots' decode state (one masked merge)."""
        m = self._t(sel)
        self._tok = torch.where(m, self._t(tok), self._tok)
        self._pos = torch.where(m, self._t(pos), self._pos)
        self._active = self._active | m
        self._gen_left = torch.where(m, self._t(gen), self._gen_left)
        self._temp = torch.where(m, self._t(temp), self._temp)
        self._topk = torch.where(m, self._t(topk), self._topk)
        self._keys = torch.where(m[:, None], self._t(keys), self._keys)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _validate(self, req: Request) -> None:
        """Reject degenerate requests at admission with a clear error."""
        p = len(req.tokens)
        if p < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens="
                f"{req.max_new_tokens} <= 0 (nothing to generate)")
        if p > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {p} > max_len="
                f"{self.max_len} (prompt alone overflows the KV cache)")
        bad = [t for t in req.tokens
               if not (0 <= int(t) < self.cfg.vocab_size)]
        if bad:
            raise ValueError(
                f"request {req.rid}: token ids {bad[:4]} outside "
                f"[0, vocab_size={self.cfg.vocab_size})")
        if req.top_k < 0:
            raise ValueError(f"request {req.rid}: top_k={req.top_k} < 0")
        if TOP_K_CAP < req.top_k < self.cfg.vocab_size:
            raise ValueError(
                f"request {req.rid}: top_k={req.top_k} exceeds "
                f"TOP_K_CAP={TOP_K_CAP} but is below vocab_size="
                f"{self.cfg.vocab_size}; use top_k <= {TOP_K_CAP}, or >= "
                f"vocab_size to disable top-k")
        if not (req.temperature >= 0 and math.isfinite(req.temperature)):
            raise ValueError(
                f"request {req.rid}: temperature={req.temperature} must "
                f"be finite and >= 0 (0 -> greedy)")
        if req.rid in self._out:
            raise ValueError(f"request {req.rid}: rid already in flight")
        need = p + req.max_new_tokens - 1
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {p} + {req.max_new_tokens} new "
                f"tokens needs {need} positions > max_len={self.max_len}")

    def _prefill(self, admit, plen, reuse, tokens, ci, col):
        """Chunked suffix prefill of one wave; returns the (S, V) logits of
        each admitted slot's last prompt token (merged chunk by chunk, so
        wave memory never scales with the chunk count) and the chunks run.
        With prefill buckets the wave runs the smallest bucket's chunk
        count; a pad chunk's write mask is all False, so it leaves the
        cache unchanged and no slot takes its logits."""
        s, c = self.max_slots, self.prefill_chunk
        suffix = plen - reuse
        n_chunks = -(-int(suffix[admit].max()) // c)
        if self._bucket_sizes:
            nb = min(b for b in self._bucket_sizes if b >= n_chunks)
            self.prefill_pad_chunks += nb - n_chunks
            if nb * c > tokens.shape[1]:
                pad = np.zeros((s, nb * c), np.int32)
                pad[:, :tokens.shape[1]] = tokens
                tokens = pad
            n_chunks = nb
        col_t = self._local(self._t(col.astype(np.int64)))
        rows = torch.arange(col_t.shape[0], device=self.device)
        last = None
        for i in range(n_chunks):
            mask = self._t(admit & (i * c < suffix))
            limit = np.minimum(plen, reuse + (i + 1) * c).astype(np.int32)
            base = (reuse + i * c).astype(np.int32)
            lg = self._chunk(self._t(tokens[:, i * c:(i + 1) * c]),
                             self._t(base), mask, self._t(limit))
            take = self._local(self._t(admit & (ci == i)))
            at = lg[rows, col_t]
            last = torch.where(take[:, None], at,
                               torch.zeros_like(at) if last is None else last)
        with self._sharded():
            last = lm.vocab_gathered(last, self.cfg)
        return self._gather(last), n_chunks

    @staticmethod
    def _priority_order(waiting: deque) -> None:
        """Stable-reorder the waiting queue by descending priority (FIFO
        within a class); a no-op when every request has priority 0, so
        such traces schedule exactly as before."""
        if any(r.priority for r in waiting):
            ordered = sorted(waiting, key=lambda r: -r.priority)
            waiting.clear()
            waiting.extend(ordered)

    def _resume_preempted(self, waiting=()) -> None:
        """Hook: swap preempted requests back in (paged engine).  Runs each
        scheduler iteration before admission; ``waiting`` lets the override
        hold back resumes a higher-priority arrival would only preempt
        again."""

    def _can_admit(self, waiting: deque) -> bool:
        """Whether ``_select_wave`` could admit anything now.  The paged
        engine also answers True with no free slot when a waiting request
        outranks a running one (admission by preemption)."""
        return bool(self._free)

    def _select_wave(self, waiting: deque) -> list[Request]:
        """Pop the next admission wave: as many waiting requests as there
        are free slots, highest priority first (the paged engine adds its
        page budget and preemption)."""
        self._priority_order(waiting)
        return [waiting.popleft()
                for _ in range(min(len(waiting), len(self._free)))]

    def _release_slot(self, sl: int, seq: tuple | None = None) -> None:
        """Hook: a slot's request finished (the paged engine releases its
        pages).  ``seq`` is the committed sequence — the prompt plus every
        generated token whose K/V was written — or None."""

    def _admit_wave(self, reqs: list[Request]) -> list[Completion]:
        """Admit up to ``free_slots`` requests in one batched prefill of
        their whole prompts."""
        t0 = time.perf_counter()
        self._check_wave(reqs)
        slots = [self._free.popleft() for _ in reqs]
        zeros = [0] * len(reqs)
        return self._start_wave(reqs, slots, zeros, zeros, t0)

    def _check_wave(self, reqs: list[Request]) -> None:
        rids = [r.rid for r in reqs]
        if len(set(rids)) != len(rids):
            raise ValueError(f"duplicate rids in one admission wave: {rids}")
        for r in reqs:
            self._validate(r)

    def _start_wave(self, reqs: list[Request], slots: list[int],
                    reuse_of: list[int], held_of: list[int],
                    t0: float) -> list[Completion]:
        """Chunked prefill of each admitted prompt from ``reuse_of`` on (the
        positions already in the cache), first tokens sampled, instant
        finishes retired, the decode state of the rest merged.
        ``held_of``: each request's pages (telemetry), ``t0`` the wave's
        start on ``time.perf_counter``."""
        tel = self.telemetry
        s, c = self.max_slots, self.prefill_chunk
        admit = np.zeros((s,), bool)
        reuse = np.zeros((s,), np.int32)
        plen = np.ones((s,), np.int32)          # 1 avoids 0-length edges
        for r, sl, ru in zip(reqs, slots, reuse_of):
            admit[sl] = True
            reuse[sl] = ru
            plen[sl] = len(r.tokens)
        suffix = plen - reuse                   # >= 1: last token always
        n_chunks = -(-int(suffix[admit].max()) // c)
        tokens = np.zeros((s, n_chunks * c), np.int32)
        ci = np.zeros((s,), np.int32)
        col = np.zeros((s,), np.int32)
        keys = np.zeros((s, 2), np.int64)
        temp = np.zeros((s,), np.float32)
        topk = np.zeros((s,), np.int32)
        for r, sl in zip(reqs, slots):
            tokens[sl, :suffix[sl]] = r.tokens[reuse[sl]:]
            ci[sl] = (suffix[sl] - 1) // c
            col[sl] = (suffix[sl] - 1) % c
            keys[sl] = request_key(r.seed if r.seed is not None
                                   else r.rid).numpy()
            temp[sl] = r.temperature
            topk[sl] = r.top_k
        last, n_chunks = self._prefill(admit, plen, reuse, tokens, ci, col)
        firsts = sample_tokens(last, step_keys(self._t(keys), self._t(plen)),
                               self._t(temp), self._t(topk)).cpu().numpy()
        wall = time.perf_counter() - t0
        self.prefill_seconds += wall
        if tel is not None:
            # the first tokens' copy to the host above synchronized the
            # wave's device work: the bracket closes on it
            tel.phases.record("admission", wall)
            tel.event("admission_wave", self.tick, n_reqs=len(reqs),
                      n_chunks=n_chunks, wall_s=wall)

        done: list[Completion] = []
        sel = np.zeros((s,), bool)
        n_tok = np.zeros((s,), np.int32)
        n_gen = np.zeros((s,), np.int32)
        for r, sl, ru, held in zip(reqs, slots, reuse_of, held_of):
            first = int(firsts[sl])
            self._out[r.rid] = [first]
            self._admitted_tick[r.rid] = self.tick
            if tel is not None:
                self._tel_note_admit(r, sl, reuse=ru, pages_held=held)
            if r.max_new_tokens == 1 or (self.eos_id >= 0
                                         and first == self.eos_id):
                self._release_slot(sl)
                self._free.appendleft(sl)
                done.append(self._complete(
                    r, "eos" if first == self.eos_id else "length"))
                continue
            self._slot_owner[sl] = r
            sel[sl] = True
            n_tok[sl] = first
            n_gen[sl] = r.max_new_tokens - 1
        if sel.any():
            self._merge_state(sel, n_tok, plen, n_gen, temp, topk, keys)
        return done

    def _complete(self, req: Request, reason: str) -> Completion:
        comp = Completion(rid=req.rid, prompt=tuple(req.tokens),
                          tokens=self._out.pop(req.rid),
                          finish_reason=reason,
                          admitted_tick=self._admitted_tick.pop(req.rid),
                          finished_tick=self.tick)
        tel = self.telemetry
        if tel is not None:
            sl, d0, a0 = self._tel_admit.pop(req.rid, (None, 0, 0))
            drafted = accepted = 0
            dr = getattr(self, "_drafted", None)
            if sl is not None and dr is not None:
                drafted = int(dr[sl]) - d0
                accepted = int(self._accepted[sl]) - a0
            tel.finish(req.rid, self.tick, reason=reason,
                       n_tokens=len(comp.tokens), drafted=drafted,
                       accepted=accepted)
        return comp

    def _tel_note_admit(self, r: Request, sl: int, *, reuse: int = 0,
                        pages_held: int = 0) -> None:
        """Record one admission (telemetry on): the lifecycle edges and a
        snapshot of the slot's cumulative spec counters, so finish can
        attribute per-request drafted/accepted as a delta."""
        tel = self.telemetry
        dr = getattr(self, "_drafted", None)
        self._tel_admit[r.rid] = (
            sl, 0 if dr is None else int(dr[sl]),
            0 if dr is None else int(self._accepted[sl]))
        tel.admit(r.rid, self.tick, slot=sl, prompt_len=len(r.tokens),
                  reuse=reuse, pages_held=pages_held)
        # the first token was sampled at the end of the admission wave
        tel.first_token(r.rid, self.tick)

    # ------------------------------------------------------------------
    # decode tick + trace scheduler
    # ------------------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def any_active(self) -> bool:
        return any(o is not None for o in self._slot_owner)

    def _engine_stats(self) -> dict:
        """Scheduler gauges for ``metrics.snapshot()["engine"]``: host
        state only, so reading them never syncs the device."""
        return {"tick": self.tick, "free_slots": self.free_slots,
                "active_slots": sum(o is not None
                                    for o in self._slot_owner),
                "inflight": len(self._out),
                "prefill_buckets": len(self._bucket_sizes),
                "prefill_pad_chunks": self.prefill_pad_chunks}

    def _dispatch_tick(self):
        """Device work of one decode tick: ``decode_block`` steps over all
        slots.  Returns the (T, S) emitted tokens (-1 = none), the
        post-tick active mask, both still on the device, and ``fin``: the
        call that closes the tick's telemetry bracket once the caller has
        copied the tokens to the host (None with telemetry off)."""
        tel = self.telemetry
        t0 = 0.0
        if tel is not None:
            tel.tick_boundary(self.tick)
            t0 = tel.phases.now()
        emits = []
        tok, pos, active, gen_left = (self._tok, self._pos, self._active,
                                      self._gen_left)
        loc = self._local
        for _ in range(self.decode_block):
            with self._sharded():
                logits = lm.decode_step(self.params, self.cfg, loc(tok),
                                        loc(pos), self.cache,
                                        nldpe=self.nldpe,
                                        write_mask=loc(active),
                                        moe_drops=self._moe_count("decode"),
                                        batch_groups=self.batch_groups)
            # each rank samples its own slots; every rank sees every token
            nxt = self._gather(sample_tokens(
                logits, step_keys(loc(self._keys), loc(pos) + 1),
                loc(self._temp), loc(self._topk)))
            emits.append(torch.where(active, nxt, -1))
            gen_left = gen_left - active.to(torch.int32)
            done = gen_left <= 0
            if self.eos_id >= 0:
                done = done | (nxt == self.eos_id)
            tok = torch.where(active, nxt, tok)
            pos = pos + active.to(torch.int32)
            active = active & ~done
        self._tok, self._pos, self._active, self._gen_left = (
            tok, pos, active, gen_left)
        self.tick += self.decode_block
        if tel is None:
            return torch.stack(emits), active, None
        tick_after = self.tick
        n_active = sum(o is not None for o in self._slot_owner)

        def fin():
            wall = tel.phases.add("decode", t0)
            tel.event("decode_block", tick_after, n_active=n_active,
                      block=self.decode_block, wall_s=wall)

        return torch.stack(emits), active, fin

    def step(self) -> list[Completion]:
        """One decode tick; returns the requests that finished in it."""
        t0 = time.perf_counter()
        emits, active, fin = self._dispatch_tick()
        # the tick's host sync (a spec tick hands over host arrays already)
        emits, active = (x.cpu().numpy() if torch.is_tensor(x) else x
                         for x in (emits, active))
        if fin is not None:
            fin()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_ticks += 1
        return self._harvest(emits, active)

    def _harvest(self, emits: np.ndarray,
                 active: np.ndarray) -> list[Completion]:
        """Fold one tick's emitted tokens (T, S) into the per-request
        outputs and retire slots that went inactive."""
        done: list[Completion] = []
        for s, req in enumerate(self._slot_owner):
            if req is None:
                continue
            self._out[req.rid].extend(int(t) for t in emits[:, s] if t >= 0)
            if not active[s]:
                last = self._out[req.rid][-1]
                reason = ("eos" if self.eos_id >= 0 and last == self.eos_id
                          else "length")
                comp = self._complete(req, reason)
                done.append(comp)
                self._slot_owner[s] = None
                self._release_slot(s, seq=comp.prompt
                                   + tuple(comp.tokens[:-1]))
                self._free.append(s)
        return done

    def run(self, requests: list[Request]) -> list[Completion]:
        """Serve a whole trace: admit each request at its ``arrival`` tick
        (or as soon after as a slot and its pages free up), decode
        continuously, return completions sorted by rid."""
        queue = deque(sorted(requests, key=lambda r: r.arrival))
        waiting: deque[Request] = deque()
        completions: list[Completion] = []
        tel = self.telemetry
        while queue or waiting or self.any_active or self._preempted:
            progressed = False
            while queue and queue[0].arrival <= self.tick:
                r = queue.popleft()
                if tel is not None:
                    tel.enqueue(r.rid, r.arrival)
                waiting.append(r)
                progressed = True
            n_pre = len(self._preempted)
            self._resume_preempted(waiting)
            progressed |= len(self._preempted) != n_pre
            if waiting and self._can_admit(waiting):
                wave = self._select_wave(waiting)
                if wave:
                    completions.extend(self._admit_wave(wave))
                    progressed = True
            if not self.any_active:
                if progressed:
                    continue        # instant finishes freed slots; re-admit
                if queue:
                    # idle until the next arrival: strictly advances the
                    # tick, so a blocked waiting queue cannot spin here
                    self.tick = max(self.tick, queue[0].arrival)
                    continue
                # nothing active, nothing arriving, and this iteration moved
                # nothing: no later iteration can differ
                if waiting:
                    raise RuntimeError(
                        f"scheduler deadlock: {len(waiting)} waiting and "
                        f"{len(self._preempted)} preempted request(s), no "
                        f"active slots, no future arrivals, and admission "
                        f"made no progress (admission blocked or the pool "
                        f"is too small for the requests)")
                if self._preempted:
                    raise RuntimeError(
                        f"{len(self._preempted)} preempted request(s) "
                        f"cannot resume into an idle engine; the page pool "
                        f"is too small for their footprints")
                break
            completions.extend(self.step())
        return sorted(completions, key=lambda c: c.rid)


class PagedServeEngine(ServeEngine):
    """Continuous batching over a paged KV cache with radix prefix sharing:
    ``ServeEngine``'s scheduler over a page pool of ``num_pages`` pages of
    ``page_size`` tokens (default ``max_slots * ceil(max_len /
    page_size)``).

    **Speculative decoding** (``spec_k > 0``): each decode tick drafts
    ``spec_k`` tokens per slot through the drafter — ``spec_draft``
    numerics (default ``NLDPEConfig(enabled=True)``, as in ``repro``) over
    the float32 weights put through the 8-bit log grid — and verifies all
    ``spec_k + 1`` positions in one exact chunk with rejection sampling,
    emitting 1 to ``spec_k + 1`` tokens per active slot.  Greedy tokens
    are the non-speculative engine's up to near-ties: kernel A's decode
    and chunk instances sum in different orders (ROADMAP.md C).  Each
    request's pages carry ``spec_k`` positions of slack for the drafts,
    and only committed positions reach the radix index.  ``spec_stats``
    holds the acceptance counters, the analog-fidelity signal.

    **Generations as prefix cache** (``cache_generations``, default True,
    as in ``repro``): a finished request's committed sequence, prompt plus
    generations, is published to the radix index at release; False
    publishes only prompts (at admission).

    **Closed-loop fidelity** (DESIGN.md §10; needs ``spec_k``): ``drift``
    (a :class:`~repro_torch.launch.fidelity.DriftInjection`) programs the
    drafter's cells — the caller's float32 master through the log grid,
    chunk by chunk (``core/drift.py``) — and reads them back, drifted and
    stuck at the virtual clock ``vclock``, into the drafter's serving copy
    every spec tick; ``fidelity`` (a ``FidelityPolicy``) closes the loop:
    a monitor folds each tick's acceptance and backs off ``spec_k_live``,
    reprograms the cells (from the master again, with a fresh key) or
    falls back to the exact decode tick.  ``fidelity_stats`` holds the
    clock, the ladder's events, the downtime and the fault census.  The
    caller keeps ``params`` unchanged while the engine lives.

    **Host spill tier** (``host_cache_pages > 0``, DESIGN.md §13): LRU
    eviction copies a refcount-0 radix page to host memory (``_spill_page``)
    and keeps its node, up to ``host_cache_pages`` pages; a radix hit on a
    spilled chain allocates fresh pages and copies it back
    (``_restore_page``) before the wave publishes.  0 keeps
    destroy-on-evict.

    **Priority preemption**: a waiting request that strictly outranks a
    running one may take its slot when no slot or page budget is free; the
    victim's decode state, position row and pages go to host memory without
    publication, and it resumes when the engine has room (``preempts``,
    ``resumes``).  Both tiers show in ``metrics.snapshot()["tiers"]`` and,
    with telemetry, as ``spill``/``restore``/``preempt``/``resume`` events.
    """

    def __init__(self, cfg, params, *, max_slots: int, max_len: int,
                 page_size: int = 16, num_pages: int | None = None,
                 host_cache_pages: int = 0,
                 spec_k: int = 0, spec_draft: NLDPEConfig | None = None,
                 cache_generations: bool = True,
                 drift: DriftInjection | None = None,
                 fidelity: FidelityPolicy | None = None, **kw):
        if "local" in cfg.layer_pattern:
            raise NotImplementedError(
                "paged KV cache needs non-windowed attention layers: ring "
                "wrap history would break prefix sharing (got 'local')")
        if drift is not None and kw.get("mesh") is not None:
            raise NotImplementedError(
                "drift injection under a mesh: the drafter's programmed "
                "cells are not sharded yet (ROADMAP.md A.2 queue, item 4: "
                "the async pipeline and drift injection under a mesh)")
        if page_size < 1:
            raise ValueError("page_size >= 1")
        if spec_k < 0:
            raise ValueError("spec_k >= 0 (0 disables speculation)")
        if (drift is not None or fidelity is not None) and not spec_k:
            raise ValueError(
                "drift/fidelity act on the analog draft path; they need "
                "spec_k > 0")
        self.spec_k = int(spec_k)
        self.cache_generations = cache_generations
        # full analog drafter by default; enabled=False keeps only the
        # log-grid weights
        self.spec_draft = (spec_draft if spec_draft is not None
                           else NLDPEConfig(enabled=True))
        self.page_size = page_size
        self.n_blocks = -(-max_len // page_size)
        self.num_pages = (max_slots * self.n_blocks if num_pages is None
                          else num_pages)
        self.host_cache_pages = int(host_cache_pages)
        self.pool = PagePool(self.num_pages, page_size,
                             host_pages=self.host_cache_pages)
        self._slot_pages: list[list[int] | None] = [None] * max_slots
        self.preempts = 0
        self.resumes = 0
        super().__init__(cfg, params, max_slots=max_slots, max_len=max_len,
                         **kw)
        # the root is keyed on the numerics and the effective storage grid
        self._fp = nldpe_fingerprint(self.nldpe, self.kv_quant)
        if self.spec_k:
            if drift is None:
                # the drafter's weights: the float32 master through the
                # log grid, then cast as any serving copy is (the float32
                # intermediate is freed on return)
                self._draft_params = self._place_params(lm.serving_params(
                    quantize_draft_params(params), self.cfg,
                    self.spec_draft))
            self._draft_fn, self._verify_fn = self._build_spec_fns(
                self.spec_k)
            # pairs at the other live depths the fidelity ladder moves to
            # (always below spec_k, which _plan budgets the slack for)
            self._spec_fn_cache: dict[int, tuple] = {}
            self.spec_k_live = self.spec_k
            self._spec_steps = 0
            self._drafted = np.zeros((max_slots,), np.int64)
            self._accepted = np.zeros((max_slots,), np.int64)
            self.spec_draft_seconds = 0.0
            # counters since the last reset_window(), and a per-tick EWMA:
            # lifetime totals cannot show a drafter degrading
            self._win_drafted = np.zeros((max_slots,), np.int64)
            self._win_accepted = np.zeros((max_slots,), np.int64)
            self._win_ticks = 0
            self.ewma_acceptance: float | None = None
        # closed-loop fidelity: drift is the plant (an aging device on a
        # virtual clock), the monitor the controller; either works alone
        self.drift = drift
        self.monitor = (FidelityMonitor(fidelity or FidelityPolicy(), spec_k)
                        if drift is not None or fidelity is not None
                        else None)
        self._ewma_alpha = (self.monitor.policy.ewma_alpha
                            if self.monitor is not None else 0.25)
        self.vclock = 0.0               # virtual seconds; never wall-clock
        self._downtime_s = 0.0
        self._reprograms = 0
        self._disabled_ticks = 0
        if drift is not None:
            self._program_drift(params)

        # registry groups over the legacy stats dicts (each group's
        # snapshot compares == to its dict); the tier gauges have a group
        # of their own, so "pool" stays == pool.stats
        me = weakref.ref(self)
        self.metrics.register_group("pool", lambda: dict(me().pool.stats))
        self.metrics.register_group("spec", lambda: me().spec_stats)
        self.metrics.register_group("fidelity", lambda: me().fidelity_stats)
        self.metrics.register_group("tiers", lambda: me()._tier_stats())
        if self.host_cache_pages > 0:
            self.pool.on_spill = lambda page: me()._spill_page(page)
        tel = self.telemetry
        if tel is not None:
            self.pool.on_evict = (
                lambda page: tel.event("eviction", me().tick, page=page))

    def _tier_stats(self) -> dict:
        return {"host_pages": self.pool.host_pages,
                "host_used": self.pool.host_used,
                "preempted_waiting": len(self._preempted),
                "preempts": self.preempts, "resumes": self.resumes}

    def _build_spec_fns(self, k: int) -> tuple:
        return (build_draft_scan_fn(self.cfg, spec_k=k, nldpe=self.spec_draft,
                                    batch_groups=self.batch_groups),
                build_verify_fn(self.cfg, self.params, spec_k=k,
                                nldpe=self.nldpe, eos_id=self.eos_id,
                                batch_groups=self.batch_groups))

    def _spec_fns_for(self, k: int) -> tuple:
        """The (draft, verify) pair at live depth ``k``: the engine's own
        at ``spec_k``, the others built once and cached."""
        if k == self.spec_k:
            return self._draft_fn, self._verify_fn
        fns = self._spec_fn_cache.get(k)
        if fns is None:
            fns = self._spec_fn_cache[k] = self._build_spec_fns(k)
        return fns

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _program_drift(self, params: dict) -> None:
        """Program the drafter's cells from the caller's float32 master
        through the log grid, one chunk at a time (the quantized float32
        drafter is never held whole: a reprogram quantizes the master
        again), and allocate the serving copy each tick's read fills, in
        the dtypes ``lm.serving_params`` gives."""
        d = self.drift
        pkey, self._drift_key, self._read_key = prng.split(
            prng.prng_key(d.seed), 3)
        self._drift_master = params
        self._sync()
        t0 = time.perf_counter()
        self._drift_state = drift_lib.program_params(
            pkey, params, d.model, target=log_quantize)
        self._sync()
        self.drift_program_seconds = time.perf_counter() - t0
        self.reprogram_seconds: list[float] = []
        self.drift_read_seconds = 0.0
        self.drift_reads = 0

        def like(x):
            if isinstance(x, dict):
                return {k: like(v) for k, v in x.items()}
            return torch.empty(x.shape, dtype=x.dtype, device="meta")

        def alloc(x):
            if isinstance(x, dict):
                return {k: alloc(v) for k, v in x.items()}
            return torch.empty(x.shape, dtype=x.dtype, device=self.device)

        self._draft_params = alloc(lm.serving_params(like(params), self.cfg,
                                                     self.spec_draft))

    def _cache_layout(self) -> dict:
        return dict(paged=(self.num_pages, self.page_size))

    @property
    def stats(self) -> dict:
        """Pool + prefix-sharing counters (see kvpool.PagePool.stats)."""
        return dict(self.pool.stats)

    @property
    def spec_stats(self) -> dict:
        """Speculative counters: drafted and accepted tokens per slot and
        in all, the acceptance rate (how often the drafter agrees with the
        exact path), its per-tick EWMA, the draft phase's wall seconds, and
        the same counters since the last :meth:`reset_window`."""
        if not self.spec_k:
            return {"spec_k": 0}
        drafted = int(self._drafted.sum())
        accepted = int(self._accepted.sum())
        wd = int(self._win_drafted.sum())
        wa = int(self._win_accepted.sum())
        return {"spec_k": self.spec_k, "spec_k_live": self.spec_k_live,
                "spec_steps": self._spec_steps,
                "drafted": drafted, "accepted": accepted,
                "acceptance_rate": accepted / max(drafted, 1),
                "ewma_acceptance": self.ewma_acceptance,
                "draft_seconds": self.spec_draft_seconds,
                "drafted_by_slot": self._drafted.tolist(),
                "accepted_by_slot": self._accepted.tolist(),
                "window": {"ticks": self._win_ticks,
                           "drafted": wd, "accepted": wa,
                           "acceptance_rate": wa / max(wd, 1),
                           "drafted_by_slot": self._win_drafted.tolist(),
                           "accepted_by_slot": self._win_accepted.tolist()}}

    def reset_window(self) -> None:
        """Zero the windowed counters of ``spec_stats["window"]``; the
        lifetime totals and the EWMA keep running."""
        if not self.spec_k:
            return
        self._win_drafted[:] = 0
        self._win_accepted[:] = 0
        self._win_ticks = 0

    @property
    def fidelity_stats(self) -> dict:
        """Closed-loop telemetry (DESIGN.md §10): virtual clock, ladder
        state and event log, reprogramming downtime, and the drift plant's
        fault census."""
        out = {"enabled": self.monitor is not None or self.drift is not None,
               "vclock_s": self.vclock,
               "spec_k_live": getattr(self, "spec_k_live", 0),
               "reprograms": self._reprograms,
               "downtime_s": self._downtime_s,
               "disabled_ticks": self._disabled_ticks}
        if self.monitor is not None:
            out.update(ewma=self.monitor.ewma,
                       disabled=self.monitor.disabled,
                       events=list(self.monitor.events),
                       events_dropped=self.monitor.events.dropped)
        if self.drift is not None:
            out["fault_fraction"] = drift_lib.fault_fraction(
                self._drift_state, self.vclock)
        return out

    # ------------------------------------------------------------------
    # closed-loop fidelity plumbing (DESIGN.md §10)
    # ------------------------------------------------------------------

    def _aged_draft_params(self) -> dict:
        """The drafter's weights *now*: the programmed cells drifted to the
        current virtual time, faulted cells stuck, read into the serving
        copy (its wall time metered behind a device sync)."""
        d = self.drift
        key = (prng.fold_in(self._read_key, self.tick) if d.read_noise
               else None)
        t0 = time.perf_counter()
        drift_lib.read_params(self._drift_state, d.model, self.vclock, key,
                              out=self._draft_params)
        self._sync()
        self.drift_read_seconds += time.perf_counter() - t0
        self.drift_reads += 1
        return self._draft_params

    def _execute_reprogram(self) -> None:
        """The ladder's recovery action: rewrite every drafter cell through
        a fresh program-and-verify pass at the current virtual time and
        meter the downtime.  Stuck cells survive reprogramming."""
        self._reprograms += 1
        if self.drift is None:
            return                      # monitor-only mode: counted, no-op
        self.vclock += self.drift.reprogram_s
        self._downtime_s += self.drift.reprogram_s
        self._drift_key, key = prng.split(self._drift_key)
        t0 = time.perf_counter()
        drift_lib.reprogram_params(key, self._drift_state,
                                   self._drift_master, self.drift.model,
                                   self.vclock, target=log_quantize)
        self._sync()
        self.reprogram_seconds.append(time.perf_counter() - t0)

    def _after_tick(self, *, drafted: int, accepted: int, k: int) -> None:
        """Advance the virtual device clock one tick and run the fidelity
        controller.  Without a drift plant the clock counts exact decode
        positions (1 per spec tick, decode_block per fallback tick)."""
        if self.drift is not None:
            self.vclock += self.drift.tick_seconds(k, self.decode_block)
        else:
            self.vclock += float(self.decode_block if k == 0 else 1)
        if self.monitor is None:
            return
        action = self.monitor.observe(drafted=drafted, accepted=accepted,
                                      t=self.vclock, tick=self.tick)
        if action == "reprogram":
            self._execute_reprogram()
        self.spec_k_live = self.monitor.spec_k
        tel = self.telemetry
        if tel is not None and action is not None:
            tel.event("fidelity", self.tick, kind=action,
                      spec_k=self.monitor.spec_k, ewma=self.monitor.ewma,
                      vclock_s=self.vclock)

    def _dispatch_tick(self):
        """One decode tick.  Without ``spec_k`` the base class's
        ``decode_block`` plain steps; with it ONE speculative step at the
        live depth ``k`` — the draft phase (its wall time metered behind a
        device sync), then the exact verify — emitting 1 to ``k + 1``
        tokens per active slot; at ``k == 0`` (the ladder disabled the
        drafter) the base class's exact tick.  A spec tick returns host
        arrays: its acceptance counters need the verify's results on the
        host."""
        if not self.spec_k:
            return super()._dispatch_tick()
        k = self.spec_k_live = (self.monitor.spec_k
                                if self.monitor is not None else self.spec_k)
        if k == 0:
            out = super()._dispatch_tick()
            self._disabled_ticks += 1
            self._after_tick(drafted=0, accepted=0, k=0)
            return out
        tel = self.telemetry
        if tel is not None:
            tel.tick_boundary(self.tick)
        pre_active = self._active.cpu().numpy()
        dparams = (self._aged_draft_params() if self.drift is not None
                   else self._draft_params)
        draft_fn, verify_fn = self._spec_fns_for(k)
        loc = self._local
        t0 = time.perf_counter()
        with self._sharded():
            drafts, q_probs = draft_fn(
                dparams, self.cache, loc(self._tok), loc(self._pos),
                loc(self._active), loc(self._temp), loc(self._topk),
                loc(self._keys))
        self._sync()                              # meter the draft alone
        dt_draft = time.perf_counter() - t0
        self.spec_draft_seconds += dt_draft
        if tel is not None:
            tel.phases.record("draft", dt_draft)
            tel.event("spec_draft", self.tick, k=k,
                      n_active=int(pre_active.sum()), wall_s=dt_draft)
        t1 = time.perf_counter()
        with self._sharded():
            out = verify_fn(
                self.cache, loc(self._tok), loc(self._pos),
                loc(self._active), loc(self._gen_left), loc(self._temp),
                loc(self._topk), loc(self._keys), drafts, q_probs)
        # each rank verified its own slots; every rank sees every slot
        (self._tok, self._pos, self._active, self._gen_left, emits,
         accepted) = (self._gather(t) for t in out)
        self.tick += 1
        self._spec_steps += 1
        drafted_now = np.where(pre_active, k, 0).astype(np.int64)
        accepted_now = np.where(pre_active, accepted.cpu().numpy(),
                                0).astype(np.int64)
        self._drafted += drafted_now
        self._accepted += accepted_now
        self._win_drafted += drafted_now
        self._win_accepted += accepted_now
        self._win_ticks += 1
        d, a = int(drafted_now.sum()), int(accepted_now.sum())
        if tel is not None:
            # the accepted counts' copy to the host above synchronized the
            # verify: the bracket closes on that existing sync
            dt_verify = tel.phases.record("verify",
                                          time.perf_counter() - t1)
            tel.event("spec_verify", self.tick, k=k, drafted=d, accepted=a,
                      wall_s=dt_verify)
        if d:
            alpha = self._ewma_alpha
            self.ewma_acceptance = (
                a / d if self.ewma_acceptance is None
                else alpha * a / d + (1 - alpha) * self.ewma_acceptance)
        self._after_tick(drafted=d, accepted=a, k=k)
        return emits_tick_major(emits), self._active.cpu().numpy(), None

    def _setup(self, admit: np.ndarray, reuse: np.ndarray,
               new_bt: np.ndarray) -> None:
        """Admission reset of the admitted slots: new block-table rows and
        a position track valid on ``[0, reuse)`` (the radix-hit prefix),
        never-valid beyond."""
        m = self._local(self._t(admit))
        iota = torch.arange(self.max_len, dtype=torch.int32,
                            device=self.device)
        fresh = torch.where(iota[None] < self._local(self._t(reuse))[:, None],
                            iota, -1)
        full = self._full()
        full["pos"].copy_(torch.where(m[:, None], fresh, full["pos"]))
        full["bt"].copy_(torch.where(m[:, None],
                                     self._local(self._t(new_bt)),
                                     full["bt"]))

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork: page ``src`` -> ``dst`` in every layer (codes
        and scales of a quantized pool alike)."""
        full = self._full()
        for name in lm.POOL_LEAVES:
            if name in full:
                full[name][:, dst] = full[name][:, src]

    # -- host tier: device->host spill, host->device restore (§13) ---------

    def _page_to_host(self, page: int) -> list:
        """Real host copies of one page's rows in every pool leaf
        (``gather_page_rows``), never views of the pool, which the next
        chunk or decode writes in place.  From the card each row goes into
        pinned memory by a blocking copy: it is done when this returns, and
        a restore reads it back at the pinned rate."""
        rows = attention.gather_page_rows(self._full(), page)
        if self.device.type != "cuda":
            return [r.clone() for r in rows]
        out = []
        for r in rows:
            host = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
            host.copy_(r)
            out.append(host)
        return out

    def _spill_page(self, page: int) -> list:
        """The pool's ``on_spill`` hook: the page's bytes to the host while
        they are still resident (the pool frees the page after it)."""
        payload = self._page_to_host(page)
        tel = self.telemetry
        if tel is not None:
            tel.event("spill", self.tick, page=page)
        return payload

    def _restore_page(self, payload: list, page: int) -> None:
        """Host->device copy of a spilled payload into physical page
        ``page`` (``scatter_page_rows``).  The copies block: the payload's
        pinned buffers have been read when this returns and may be freed
        or reused at once."""
        attention.scatter_page_rows(self._full(), payload, page)

    def _plan(self, req: Request, *, peek: bool) -> dict:
        """Map a request onto pages: radix-hit pages to share, the spilled
        continuation of the hit chain to restore, an optional COW fork of
        the boundary page, and the fresh pages its prompt + gen footprint
        needs.  ``peek=True`` never touches pool state and also reports
        ``cost`` (fresh pages plus refcount-0 hits, which retaining takes
        out of the evictable set); without it the spilled nodes are pinned
        until admission restores them (or unpins them on a rollback)."""
        ps = self.page_size
        plen = len(req.tokens)
        hit, spill = self.pool.match_tiers(self._fp, req.tokens, peek=peek)
        fork_src = fork_node = None
        n_hit = len(hit) + len(spill)
        if n_hit and n_hit * ps > plen - 1:
            # the cache covers the whole prompt: the boundary page becomes
            # private (final-token recompute + decode appends land in it).
            # A spilled boundary is a payload fork: its host bytes go
            # straight into the private page and the node stays spilled.
            if spill:
                fork_node, spill = spill[-1], spill[:-1]
            else:
                fork_src, hit = hit[-1], hit[:-1]
            reuse = plen - 1
        else:
            reuse = n_hit * ps
        # spec_k positions of slack: a spec step writes drafted K/V up to
        # spec_k positions past the committed tip, into pages the slot owns
        # (capped at max_len: the position track drops anything beyond)
        footprint = min(plen + req.max_new_tokens - 1 + self.spec_k,
                        self.max_len)
        nb_need = -(-footprint // ps)
        # fresh pages take the restores, the fork and the suffix: only
        # resident hits come free
        plan = {"hit": hit, "spill": spill, "fork_src": fork_src,
                "fork_node": fork_node, "reuse": reuse, "nb_need": nb_need,
                "n_fresh": nb_need - len(hit)}
        if peek:
            plan["ref0_pages"] = [p for p in hit
                                  if self.pool.refcount(p) == 0]
        return plan

    def _select_wave(self, waiting: deque) -> list[Request]:
        """Admit requests, highest priority first, while both a slot and
        their page budget fit; raise if the head request cannot fit even an
        idle pool.  When the head does not fit, a strictly lower-priority
        running slot may be preempted to make room — only while the wave
        is still empty, so every plan this call keeps postdates every
        preemption it makes (a victim's released pages change the
        refcount-0 and hit picture)."""
        self._priority_order(waiting)
        wave: list[Request] = []
        spent = 0
        charged: set[int] = set()     # ref-0 hit pages already budgeted
        while waiting:
            if len(wave) >= len(self._free):
                if wave or not self._preempt_for(waiting[0]):
                    break
                continue                # a slot freed; re-check the head
            plan = self._plan(waiting[0], peek=True)
            ref0_new = [p for p in plan["ref0_pages"] if p not in charged]
            cost = plan["n_fresh"] + len(ref0_new)
            if cost > self.pool.available() - spent:
                if wave or not self._preempt_for(waiting[0]):
                    break
                continue                # pages freed; replan the head
            charged.update(ref0_new)
            spent += cost
            wave.append(waiting.popleft())
        if not wave and waiting and not self.any_active:
            plan = self._plan(waiting[0], peek=True)
            need = plan["n_fresh"] + len(plan["ref0_pages"])
            raise RuntimeError(
                f"request {waiting[0].rid} needs {need} pages but the pool "
                f"holds {self.pool.num_pages} (page_size="
                f"{self.page_size}); grow num_pages or shrink the request")
        return wave

    # -- priority preemption: a running slot out to the host and back -------

    def _can_admit(self, waiting: deque) -> bool:
        """A full engine can still admit when a waiting request strictly
        outranks a running slot: ``_select_wave`` preempts the victim."""
        if self._free:
            return True
        top = max(r.priority for r in waiting)
        return any(r is not None and r.priority < top
                   for r in self._slot_owner)

    def _preempt_for(self, incoming: Request) -> bool:
        """Swap out one running victim for a strictly higher-priority
        incoming request.  The victim order is total — lowest priority,
        then most recently admitted, then highest rid — so scheduling, and
        every token after it, is reproducible."""
        victims = [(r.priority, -self._admitted_tick[r.rid], -r.rid, sl)
                   for sl, r in enumerate(self._slot_owner)
                   if r is not None and r.priority < incoming.priority]
        if not victims:
            return False
        self._preempt_slot(min(victims)[3])
        return True

    def _preempt_slot(self, sl: int) -> None:
        """Swap slot ``sl`` out to the host: copy its decode state, key,
        position-track row and every block-table page's bytes, then release
        the pages WITHOUT publishing them (K/V past the committed prefix
        must never enter the radix index) and clear the slot's active bit.
        Every snapshot is a host copy, not the live tensors the next tick
        rebinds or writes in place.  The payloads are the engine's and take
        none of the pool's ``host_pages`` (preemption works with the spill
        tier off)."""
        req = self._slot_owner[sl]
        assert req is not None, "preempt of an empty slot"
        state = [t[sl].tolist() for t in (self._tok, self._pos,
                                          self._gen_left, self._temp,
                                          self._topk, self._keys)]
        tok, pos, gen, temp, topk, keys = state
        pos_row = self._slot_track("pos", sl).to("cpu", copy=True)
        pages = self._slot_pages[sl]
        payloads = [self._page_to_host(p) for p in pages]
        tel = self.telemetry
        carry = (0, 0)
        if tel is not None and req.rid in self._tel_admit and self.spec_k:
            _, d0, a0 = self._tel_admit[req.rid]
            carry = (int(self._drafted[sl]) - d0,
                     int(self._accepted[sl]) - a0)
        self.pool.release(pages)
        self._slot_pages[sl] = None
        self._slot_owner[sl] = None
        self._free.append(sl)
        # the decode freezes the row (its block table still maps the
        # released pages, which it may read but never writes)
        mask = np.zeros((self.max_slots,), bool)
        mask[sl] = True
        self._active = self._active & ~self._t(mask)
        self._preempted.append(_Preempted(
            req=req, tok=tok, pos=pos, gen_left=gen, temp=temp, topk=topk,
            keys=np.asarray(keys, np.int64), pos_row=pos_row,
            payloads=payloads, tel_carry=carry))
        self.preempts += 1
        if tel is not None:
            tel.event("preempt", self.tick, rid=req.rid, slot=sl,
                      pages=len(payloads), priority=req.priority)

    def _resume_preempted(self, waiting=()) -> None:
        """Swap preempted requests back in, highest priority first (FIFO
        within a class).  A strictly higher-priority *waiting* request holds
        resumes back: admission would only preempt the resumed one again."""
        if not self._preempted:
            return
        self._preempted.sort(key=lambda p: -p.req.priority)
        top_wait = max((r.priority for r in waiting), default=None)
        kept: list[_Preempted] = []
        for pre in self._preempted:
            if (self._free
                    and (top_wait is None or pre.req.priority >= top_wait)
                    and self._resume_one(pre)):
                continue
            kept.append(pre)
        self._preempted = kept

    def _resume_one(self, pre: _Preempted) -> bool:
        """Restore one preempted request into a free slot: fresh pages, its
        payloads copied in, the slot's block-table row and saved position
        row, its decode state merged back."""
        n = len(pre.payloads)
        fresh = self.pool.alloc(n)
        if fresh is None:
            return False
        sl = self._free.popleft()
        for payload, pg in zip(pre.payloads, fresh):
            self._restore_page(payload, pg)
        row = np.full((self.n_blocks,), self.num_pages, np.int32)
        row[:n] = fresh
        self._set_slot_track("bt", sl, self._t(row))
        self._set_slot_track("pos", sl, pre.pos_row.to(self.device))
        s = self.max_slots
        sel = np.zeros((s,), bool)
        sel[sl] = True

        def one(v, dtype):
            a = np.zeros((s,) + np.shape(v), dtype)
            a[sl] = v
            return a

        self._merge_state(sel, one(pre.tok, np.int32), one(pre.pos, np.int32),
                          one(pre.gen_left, np.int32),
                          one(pre.temp, np.float32), one(pre.topk, np.int32),
                          one(pre.keys, np.int64))
        self._slot_pages[sl] = list(fresh)
        self._slot_owner[sl] = pre.req
        self.resumes += 1
        tel = self.telemetry
        if tel is not None:
            # re-seed the request's spec baseline so finish reports its
            # drafted/accepted as if it had never been preempted
            base_d = base_a = 0
            if self.spec_k:
                base_d = int(self._drafted[sl]) - pre.tel_carry[0]
                base_a = int(self._accepted[sl]) - pre.tel_carry[1]
            self._tel_admit[pre.req.rid] = (sl, base_d, base_a)
            tel.event("resume", self.tick, rid=pre.req.rid, slot=sl,
                      pages=n)
        return True

    def _release_slot(self, sl: int, seq: tuple | None = None) -> None:
        """A slot's request finished: with ``cache_generations``, publish
        its committed sequence (the prompt plus every generated token whose
        K/V was written) as prefix cache — only pages every position of
        which is committed, so draft K/V and the spec slack never enter the
        index — then drop the slot's page references."""
        pages = self._slot_pages[sl]
        if pages is not None:
            if seq is not None and self.cache_generations:
                self.pool.publish_committed(self._fp, seq, pages)
            self.pool.release(pages)
            self._slot_pages[sl] = None

    def _admit_wave(self, reqs: list[Request]) -> list[Completion]:
        """Plan -> retain/alloc and restore -> COW -> publish -> reset ->
        suffix prefill -> sample first tokens -> merge decode state."""
        t0 = time.perf_counter()
        self._check_wave(reqs)
        s = self.max_slots
        tel = self.telemetry

        # Phase 1: plan + commit pool state for every request before any
        # publish: wave-mates never share each other's pages (their prefill
        # runs in the same chunk calls).
        slots = [self._free.popleft() for _ in reqs]
        plans = []
        for r, sl in zip(reqs, slots):
            plan = self._plan(r, peek=False)
            self.pool.retain(plan["hit"])
            fresh = self.pool.alloc(plan["n_fresh"])
            if fresh is None:
                self.pool.release(plan["hit"])
                self.pool.unpin(plan["spill"])
                if plan["fork_node"] is not None:
                    self.pool.unpin([plan["fork_node"]])
                for pl in plans:
                    self.pool.release(pl["hit"])
                    self.pool.release(pl["fresh"])
                    # their spilled chains are restored (resident cache
                    # now, no pin); only a pending payload fork holds one
                    if pl["fork_node"] is not None:
                        self.pool.unpin([pl["fork_node"]])
                for sl2 in reversed(slots):
                    self._free.appendleft(sl2)
                raise RuntimeError(
                    f"request {r.rid}: page pool exhausted "
                    f"({self.pool.available()} available, "
                    f"{plan['n_fresh']} needed)")
            plan["fresh"] = fresh
            # restore the spilled chain now, top down, into the leading
            # fresh pages: before the next request plans (a wave-mate
            # sharing the chain sees resident hits and never restores it
            # twice) and before publish
            for nd, pg in zip(plan["spill"], fresh):
                self._restore_page(nd.payload, pg)
                self.pool.restore(nd, pg)
                if tel is not None:
                    tel.event("restore", self.tick, page=pg)
            plans.append(plan)

        # every allocation succeeded: COW copies and stats only now, so a
        # failed wave leaves the cache and the savings counters untouched
        for sl, plan in zip(slots, plans):
            fresh = plan["fresh"]
            restored = fresh[:len(plan["spill"])]
            rest = fresh[len(plan["spill"]):]
            nd = plan["fork_node"]
            if nd is not None or plan["fork_src"] is not None:
                fork_dst = rest[0]
                # a spilled boundary forks from its payload, unless a
                # wave-mate restored the node in Phase 1: then an ordinary
                # device-side copy (the bytes are the same)
                src = plan["fork_src"] if nd is None else nd.page
                if src >= 0:
                    self._copy_page(src, fork_dst)
                else:
                    self._restore_page(nd.payload, fork_dst)
                if nd is not None:
                    self.pool.unpin([nd])
                self.pool.note_cow()
                if tel is not None:
                    tel.event("cow_fork", self.tick, src=src, dst=fork_dst)
            bt_row = plan["hit"] + restored + rest
            assert len(bt_row) == plan["nb_need"]
            plan["bt_row"] = bt_row
            self._slot_pages[sl] = list(bt_row)
            self.pool.stats["prefill_tokens_saved"] += plan["reuse"]

        # Phase 2: publish full prompt pages for future waves
        for r, plan in zip(reqs, plans):
            n_full = len(r.tokens) // self.page_size
            self.pool.publish(self._fp, r.tokens, plan["bt_row"][:n_full])

        # Phase 3: block tables + position tracks of the admitted slots
        admit = np.zeros((s,), bool)
        reuse = np.zeros((s,), np.int32)
        new_bt = np.full((s, self.n_blocks), self.num_pages, np.int32)
        for sl, plan in zip(slots, plans):
            admit[sl] = True
            reuse[sl] = plan["reuse"]
            new_bt[sl, :plan["nb_need"]] = plan["bt_row"]
        self._setup(admit, reuse, new_bt)

        # Phase 4: chunked suffix prefill at per-slot base positions
        return self._start_wave(reqs, slots,
                                [plan["reuse"] for plan in plans],
                                [plan["nb_need"] for plan in plans], t0)
