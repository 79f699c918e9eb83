"""Decoder-only LM over repeating layer patterns (port of the serving and
training parts of ``repro.models.lm``).

Block types: ``attn`` (GQA attention + gated MLP), ``local`` (the same
over a sliding window, Gemma3's local layers), ``global`` (full attention
with ``rope_theta_global``, Gemma3's global layers), ``moe`` (attention +
the MoE FFN of ``nn/moe.py``, Qwen3-MoE and Llama4-Scout), ``rec`` (the
RG-LRU recurrent block + MLP, RecurrentGemma) and ``rwkv`` (RWKV6
time-mix + channel-mix, ``nn/rwkv6.py``) — all of ``repro``'s.

Parameters keep ``repro``'s tree, names and layout: ``groups.b0 ...
b{P-1}`` for the P block types of ``cfg.layer_pattern``, each leaf stacked
over ``n_layers // P`` repetitions, then ``tail.b0 ...`` (unstacked) for
the remainder, so ``convert.from_jax`` maps one onto the other leaf by
leaf.  Layers run in ``repro``'s order: every group's b0 ... b{P-1}, group
after group, then the tail.  Where ``repro`` scans over the stacked
groups, the port loops over layers in Python.

The model cache keeps one stack per kind of layer state, each stacked on
a leading layer axis in run order (``cache_slots`` maps a layer onto its
stack and row).  Code outside this module reaches a stack by its name
through ``stacks(cache)`` ("full", "ring", "rec", "rwkv"), and
``cache_pspecs`` gives one placement tree per stack:

* the **full-length** attention layers (``attn``, ``global``, ``moe``) at
  the top level, as the ``("attn",)`` models have always had it:
  lockstep ``{"k", "v", "pos"}`` with K/V (L, B, Hkv, max_len, D) and pos
  (max_len,);
  slotted: pos (B, max_len); paged ``{"k", "v", "pos", "bt"}``: pools (L,
  P, Hkv, page_size, D), pos (B, max_len), block table (B, NB);
* the **windowed** layers (``local``) under ``"ring"``: the same dense
  layouts over rings of ``min(max_len, window + ring_slack)`` lines;
* the **recurrent** layers (``rec``) under ``"rec"``: ``{"h": (L, B,
  d_rnn), "conv": (L, B, 3, d_rnn)}`` float32;
* the **RWKV6** layers (``rwkv``) under ``"rwkv"``: ``{"tm": {"S": (L, B,
  H, 64, 64), "x_last": (L, B, d)}, "cm_x": (L, B, d)}`` float32, written
  in place as ``"rec"`` is.  ``repro``'s fresh state is float32 and its
  carried ``x_last`` rows are in the activation dtype (the token shift's
  promotion follows the dtype): the whole-prompt prefill reads the stack
  as float32 (the fresh state), a decode step in the activation dtype
  (the carried one, which float32 holds exactly).

Each attention stack has ONE position track — ``repro`` keeps a copy per
layer, but every layer of a stack holds the same values — so a forward
computes one write plan per stack (per distinct cache length).  A config
whose ``kv_cache_dtype`` is "int8" or "log8" gets quantized K/V in every
attention stack.  Paged caches hold full-length layers only, as in
``repro``.  Chunked serve prefill (mode "chunk") runs attention blocks
only (``rec`` and ``rwkv`` raise, as in ``repro``).

Each MoE layer routes the forward's tokens as one group.  ``moe_drops``
((2,) int64 on the device) counts the expert assignments dropped for
capacity: those of live tokens (``moe_live``; by default every token of a
slot the forward writes) and those of padding rows.

``forward(..., patch_embeds=)`` is the VLM frontend stub (PaliGemma): the
(B, P, d) patch embeddings are prepended to the token embeddings and the
first P positions attend to each other both ways (a prefix-LM), in the
whole-sequence modes; a lockstep cache is then filled over all P + S
positions, so decode continues at P + S.

``forward(mode="train")`` is the differentiable whole-sequence pass of
training (no cache); with ``cfg.scan_remat`` each layer is recomputed in
the backward pass (``torch.utils.checkpoint``), as ``jax.checkpoint``
wraps the reference's scan body.  A stacked leaf may also be a list of
per-layer tensors (the train step's run copy).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core.engine import NLDPEConfig, OFF
from ..core.quantization import KV_QUANT_MODES, scalar_div
from ..nn.attention import (AttnSpec, attn_apply, init_cache, kv_leaves,
                            write_plan)
from ..nn.basic import embedding_apply, rmsnorm_apply, unembed_apply
from ..nn.mlp import mlp_apply
from ..nn.moe import group_tokens, may_drop, moe_apply
from ..nn.rglru import recurrent_block_apply, recurrent_state_init
from ..nn.rwkv6 import (HEAD_SIZE, channelmix_apply, rwkv_state_init,
                        timemix_apply)
from ..parallel.context import (act_axes, current, enter, gather_params,
                                installed, reduce_partial)

ATTN_TYPES = ("attn", "local", "global", "moe")
BLOCK_TYPES = ("attn", "local", "global", "moe", "rec", "rwkv")
POOL_LEAVES = ("k", "v", "k_scale", "v_scale")
CONV_WIDTH = 4


def kv_quant_of(cfg) -> str | None:
    """The KV storage grid ``cfg.kv_cache_dtype`` names, or None (fp)."""
    return (cfg.kv_cache_dtype if cfg.kv_cache_dtype in KV_QUANT_MODES
            else None)


def attn_spec(cfg, btype: str = "attn") -> AttnSpec:
    """The attention of a ``btype`` block: ``local`` takes the window,
    ``global`` the global rope theta (where the config has one)."""
    theta = cfg.rope_theta
    if btype == "global" and cfg.rope_theta_global:
        theta = cfg.rope_theta_global
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, rope_theta=theta,
                    window=cfg.window if btype == "local" else None,
                    qk_norm=cfg.qk_norm, softcap=cfg.attn_softcap,
                    kv_quant=kv_quant_of(cfg))


def _check_cfg(cfg) -> None:
    bad = sorted({t for t in cfg.layer_pattern if t not in BLOCK_TYPES})
    if bad:
        raise ValueError(f"{cfg.name}: unknown block types {bad}; the "
                         f"model runs {BLOCK_TYPES}")
    if "moe" in cfg.layer_pattern and cfg.moe is None:
        raise ValueError(f"{cfg.name}: 'moe' blocks need cfg.moe")


def _pattern_split(cfg):
    pat = cfg.layer_pattern
    n_groups = cfg.n_layers // len(pat)
    tail = pat[: cfg.n_layers % len(pat)]
    return pat, n_groups, tail


def layer_order(cfg) -> list[tuple[str, str, str, int | None]]:
    """Every layer in run order as (block type, "groups" or "tail", block
    key "b{i}", group index or None)."""
    pat, n_groups, tail = _pattern_split(cfg)
    out = [(t, "groups", f"b{i}", g)
           for g in range(n_groups) for i, t in enumerate(pat)]
    out += [(t, "tail", f"b{i}", None) for i, t in enumerate(tail)]
    return out


def _stack_of(cfg, btype: str) -> str:
    """The cache stack a ``btype`` layer lives in: "full", "ring", "rec"
    or "rwkv"."""
    if btype in ("rec", "rwkv"):
        return btype
    return "ring" if attn_spec(cfg, btype).window else "full"


def cache_slots(cfg) -> list[tuple[str, int]]:
    """Per layer in run order, its cache stack and row in that stack."""
    seen: dict[str, int] = {}
    out = []
    for btype, *_ in layer_order(cfg):
        st = _stack_of(cfg, btype)
        out.append((st, seen.get(st, 0)))
        seen[st] = seen.get(st, 0) + 1
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters with ``repro``'s tree and init distributions
    (``nn/module.py:58``): normal scaled by fan_in^-1/2 for projections
    — the leading axis's size, so the MoE's (E, ., .) expert weights draw
    at E^-1/2 —, 0.02 for the embedding and the MoE router, (Hq*Dh)^-1/2
    for the output projection, 0.1 for the RG-LRU conv, RWKV6's lerp
    ratios and bonus, 0.5 for the RG-LRU Lambda, 0.01 for RWKV6's decay
    LoRA, zero biases and decay base, unit norm scales.  Drawn from
    ``generator`` on ``device`` (the card unless ``device="cpu"``);
    ``device="meta"`` gives the tree's shapes and dtypes without values
    (``param_shapes``)."""
    _check_cfg(cfg)
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    d = cfg.d_model
    pat, n_groups, tail = _pattern_split(cfg)

    def normal(lead, shape, scale):
        x = torch.randn((*lead, *shape), generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale)

    def const(lead, shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=device)

    def block(btype, lead):
        p = {"norm1": {"scale": const(lead, (d,), 1.0)},
             "norm2": {"scale": const(lead, (d,), 1.0)}}
        if btype == "rwkv":
            h, rank = d // HEAD_SIZE, 64
            p["tm"] = {"mu": normal(lead, (5, d), 0.1),
                       "w_r": normal(lead, (d, d), d ** -0.5),
                       "w_k": normal(lead, (d, d), d ** -0.5),
                       "w_v": normal(lead, (d, d), d ** -0.5),
                       "w_g": normal(lead, (d, d), d ** -0.5),
                       "w_o": normal(lead, (d, d), d ** -0.5),
                       "decay_base": const(lead, (d,), 0.0),
                       "decay_A": normal(lead, (d, rank), 0.01),
                       "decay_B": normal(lead, (rank, d), 0.01),
                       "bonus_u": normal(lead, (h, HEAD_SIZE), 0.1)}
            p["cm"] = {"mu": normal(lead, (2, d), 0.1),
                       "w_k": normal(lead, (d, cfg.d_ff), d ** -0.5),
                       "w_v": normal(lead, (cfg.d_ff, d), cfg.d_ff ** -0.5),
                       "w_r": normal(lead, (d, d), d ** -0.5)}
            return p
        if btype == "rec":
            dr = cfg.d_rnn or d
            p["rec"] = {
                "in_gate": normal(lead, (d, dr), d ** -0.5),
                "in_x": normal(lead, (d, dr), d ** -0.5),
                "conv": normal(lead, (CONV_WIDTH, dr), 0.1),
                "rglru": {"w_a": normal(lead, (dr, dr), dr ** -0.5),
                          "b_a": const(lead, (dr,), 0.0),
                          "w_x": normal(lead, (dr, dr), dr ** -0.5),
                          "b_x": const(lead, (dr,), 0.0),
                          "lam": normal(lead, (dr,), 0.5)},
                "out": normal(lead, (dr, d), dr ** -0.5)}
        else:
            s = attn_spec(cfg, btype)
            attn = {"wq": normal(lead, (d, s.n_heads, s.head_dim), d ** -0.5),
                    "wk": normal(lead, (d, s.n_kv_heads, s.head_dim),
                                 d ** -0.5),
                    "wv": normal(lead, (d, s.n_kv_heads, s.head_dim),
                                 d ** -0.5),
                    "wo": normal(lead, (s.n_heads, s.head_dim, d),
                                 (s.n_heads * s.head_dim) ** -0.5)}
            if cfg.qkv_bias:
                attn.update(bq=const(lead, (s.n_heads, s.head_dim), 0.0),
                            bk=const(lead, (s.n_kv_heads, s.head_dim), 0.0),
                            bv=const(lead, (s.n_kv_heads, s.head_dim), 0.0))
            if cfg.qk_norm:
                attn["q_norm"] = {"scale": const(lead, (s.head_dim,), 1.0)}
                attn["k_norm"] = {"scale": const(lead, (s.head_dim,), 1.0)}
            p["attn"] = attn
        if btype == "moe":
            m = cfg.moe
            e, f = m.n_experts, m.d_expert_ff
            p["ffn"] = {"router": normal(lead, (d, e), 0.02),
                        "gate": normal(lead, (e, d, f), e ** -0.5),
                        "up": normal(lead, (e, d, f), e ** -0.5),
                        "down": normal(lead, (e, f, d), e ** -0.5)}
            return p
        ffn = {"up": normal(lead, (d, cfg.d_ff), d ** -0.5),
               "down": normal(lead, (cfg.d_ff, d), cfg.d_ff ** -0.5)}
        if cfg.gated_mlp:
            ffn["gate"] = normal(lead, (d, cfg.d_ff), d ** -0.5)
        p["ffn"] = ffn
        return p

    table = torch.randn((cfg.vocab_size, d), generator=generator,
                        device=device, dtype=torch.float32).mul_(0.02)
    params = {"embed": {"table": table},
              "groups": {f"b{i}": block(t, (n_groups,))
                         for i, t in enumerate(pat)},
              "final_norm": {"scale": const((), (d,), 1.0)}}
    if tail:
        params["tail"] = {f"b{i}": block(t, ()) for i, t in enumerate(tail)}
    if not cfg.tie_embeddings:
        w = torch.randn((d, cfg.vocab_size), generator=generator,
                        device=device, dtype=torch.float32) * d ** -0.5
        params["lm_head"] = {"w": w}
    return params


def param_shapes(cfg) -> dict:
    """``init_params(cfg)``'s tree on the meta device: every leaf's global
    shape, no storage (what ``nn.module.spec_tree`` resolves)."""
    return init_params(cfg, device="meta")


# leaves the model reads in float32 whatever the activation dtype
_F32_LEAVES = ("q_norm", "k_norm", "lam", "router", "decay_base", "decay_A",
               "decay_B", "bonus_u")


def serving_params(params: dict, cfg, nldpe: NLDPEConfig = OFF) -> dict:
    """The parameter tree a server runs from: every block's matmul weights
    and biases (attention, MLP, MoE experts, recurrent block, RWKV6) cast
    once to the activation dtype — the values ``x @ w.astype(x.dtype)``
    gives per call in ``repro`` — except what the model reads in float32
    (the qk-norm scales, RG-LRU's Lambda, the MoE router, RWKV6's decay
    LoRA and bonus) and, under ``FUSED``, the weight the crossbar->ACAM
    kernel programs from the float32 master: a dense MLP's gate, or the
    up projection of a non-gated one (MusicGen's plain GELU MLP; the MoE's
    expert gates never reach that kernel, so they are cast too)."""
    act = cfg.activation_dtype
    fused = nldpe.fused_linear

    def cast(tree, keep=()):
        if isinstance(tree, dict):
            return {k: v if k in keep or k in _F32_LEAVES else cast(v)
                    for k, v in tree.items()}
        return tree.to(act)

    def block(blk):
        out = dict(blk)
        for name in ("attn", "rec", "tm", "cm"):
            if name in blk:
                out[name] = cast(blk[name])
        if "ffn" in blk:
            ffn = blk["ffn"]
            keep = ()
            if fused and "router" not in ffn:
                keep = ("gate",) if "gate" in ffn else ("up",)
            out["ffn"] = cast(ffn, keep=keep)
        return out

    out = dict(params)
    for where in ("groups", "tail"):
        if where in params:
            out[where] = {k: block(v) for k, v in params[where].items()}
    return out


def init_model_cache(cfg, batch: int, max_len: int, *,
                     paged: tuple[int, int] | None = None,
                     slotted: bool = False, ring_slack: int = 0,
                     dtype=torch.float32, device=None) -> dict:
    """Every layer's cache (the module docstring's stacks): dense lockstep
    (default), dense ``slotted``, or ``paged=(num_pages, page_size)``
    (unmapped block-table entries hold the sentinel ``num_pages``; full-
    length attention layers only); windowed rings of ``min(max_len,
    window + ring_slack)`` lines; int8 codes and float32 scales in place
    of ``dtype`` values when ``cfg.kv_cache_dtype`` names a grid."""
    _check_cfg(cfg)
    device = resolve_device(device)
    order = layer_order(cfg)
    count = {"full": 0, "ring": 0, "rec": 0, "rwkv": 0}
    first = {}
    for btype, *_ in order:
        st = _stack_of(cfg, btype)
        count[st] += 1
        first.setdefault(st, btype)
    if paged is not None and (count["ring"] or count["rec"]
                              or count["rwkv"]):
        raise NotImplementedError(
            "paged KV cache supports non-windowed attention layers only")
    cache: dict = {}
    if count["full"]:
        s = attn_spec(cfg, first["full"])
        if paged is None:
            cache = init_cache(s, batch, max_len, layers=count["full"],
                               dtype=dtype, slotted=slotted, device=device)
        else:
            num_pages, page_size = paged
            kv = (count["full"], num_pages, s.n_kv_heads, page_size,
                  s.head_dim)
            cache = kv_leaves(kv, dtype, s.kv_quant, device)
            cache["pos"] = torch.full((batch, max_len), -1,
                                      dtype=torch.int32, device=device)
            cache["bt"] = torch.full((batch, -(-max_len // page_size)),
                                     num_pages, dtype=torch.int32,
                                     device=device)
    if count["ring"]:
        cache["ring"] = init_cache(attn_spec(cfg, first["ring"]), batch,
                                   max_len, layers=count["ring"], dtype=dtype,
                                   slotted=slotted, ring_slack=ring_slack,
                                   device=device)
    if count["rec"]:
        cache["rec"] = recurrent_state_init(batch, cfg.d_rnn or cfg.d_model,
                                            CONV_WIDTH, layers=count["rec"],
                                            device=device)
    if count["rwkv"]:
        cache["rwkv"] = rwkv_state_init(batch, cfg.d_model,
                                        layers=count["rwkv"], device=device)
    return cache


def cache_pspecs(cfg, batch: int, max_len: int, mesh, rules, *,
                 slotted: bool = False, ring_slack: int = 0,
                 paged: tuple[int, int] | None = None) -> dict:
    """The placement of every cache leaf, as a tree mirroring
    ``init_model_cache`` (the same arguments): one spec tree per stack —
    ``nn.attention.cache_specs`` for the attention stacks (their quantized
    pools' scales included), the batch and the "mlp"/"heads" axes for the
    RG-LRU and RWKV6 states — each leaf ``repro``'s ``cache_pspecs`` of
    the same layer behind the stack's layer axis."""
    from ..nn.attention import cache_specs
    from ..parallel.sharding import Spec, resolve

    def stacked(axes, shape):
        return Spec((None, *resolve(rules, axes, shape, mesh)))

    first = {}
    for btype, *_ in layer_order(cfg):
        first.setdefault(_stack_of(cfg, btype), btype)
    out: dict = {}
    if "full" in first:
        out.update(cache_specs(attn_spec(cfg, first["full"]), batch,
                               max_len, mesh, rules, slotted=slotted,
                               paged=paged))
    if "ring" in first:
        out["ring"] = cache_specs(attn_spec(cfg, first["ring"]), batch,
                                  max_len, mesh, rules, slotted=slotted,
                                  ring_slack=ring_slack)
    if "rec" in first:
        dr = cfg.d_rnn or cfg.d_model
        out["rec"] = {"h": stacked(("batch", "mlp"), (batch, dr)),
                      "conv": stacked(("batch", None, "mlp"),
                                      (batch, CONV_WIDTH - 1, dr))}
    if "rwkv" in first:
        d = cfg.d_model
        row = stacked(("batch", None), (batch, d))
        out["rwkv"] = {"tm": {"S": stacked(("batch", "heads", None, None),
                                           (batch, d // HEAD_SIZE,
                                            HEAD_SIZE, HEAD_SIZE)),
                              "x_last": row},
                       "cm_x": row}
    return out


STACKS = ("full", "ring", "rec", "rwkv")


def stacks(cache: dict) -> dict:
    """Every stack of a model cache by name ("full", "ring", "rec",
    "rwkv"; the module docstring's layout).  The full-length stack is the
    cache's top-level tensors (a new dict over the same tensors: in-place
    writes land in the cache)."""
    out = {}
    if "pos" in cache:
        out["full"] = {k: v for k, v in cache.items() if torch.is_tensor(v)}
    for name in STACKS[1:]:
        if name in cache:
            out[name] = cache[name]
    return out


def attention_stacks(cache: dict) -> dict:
    """The attention stacks ("full", "ring") of a model cache by name."""
    return {k: v for k, v in stacks(cache).items() if k in ("full", "ring")}


def position_tracks(cache: dict) -> list:
    """Every attention stack's position track."""
    return [st["pos"] for st in attention_stacks(cache).values()]


def layer_cache(stack: dict, i: int) -> dict:
    """Layer ``i``'s view of an attention stack (the model cache for the
    full-length layers): K/V and scales are views, so writes land in the
    stack; the position track and block table are the stack's own."""
    return {n: t[i] if n in POOL_LEAVES else t for n, t in stack.items()
            if torch.is_tensor(t)}


def clone_cache(cache: dict) -> dict:
    """A copy of a model cache, every tensor cloned."""
    return {k: clone_cache(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


def apply_block(p: dict, cfg, btype: str, x: torch.Tensor, *,
                positions: torch.Tensor, mode: str, cache=None, plan=None,
                nldpe: NLDPEConfig = OFF,
                moe_drops: torch.Tensor | None = None,
                moe_live: torch.Tensor | None = None,
                dense_rows: torch.Tensor | None = None,
                prefix_len: int | None = None,
                groups: int = 1) -> torch.Tensor:
    """One block: x (B, S, d) -> x.  ``cache`` is the layer's view of its
    attention stack (written in place at ``plan``) or, for ``rec`` and
    ``rwkv``, its state (views of the stack, overwritten in place).
    ``dense_rows`` and ``prefix_len``: see ``nn.attention.attn_apply``;
    ``groups``: the MoE routing groups (``nn.moe.moe_apply``)."""
    if btype in ("rec", "rwkv") and mode == "chunk":
        raise NotImplementedError("chunked serve prefill supports "
                                  f"attention blocks only (got '{btype}')")
    h = rmsnorm_apply(p["norm1"], x)
    if btype == "rwkv":
        return _rwkv_block(p, x, h, mode=mode, cache=cache, nldpe=nldpe)
    if btype == "rec":
        a, st = recurrent_block_apply(p["rec"], h, cache, mode=mode,
                                      nldpe=nldpe)
        if cache is not None:
            cache["h"].copy_(st["h"])
            cache["conv"].copy_(st["conv"])
    else:
        a = attn_apply(p["attn"], attn_spec(cfg, btype), h,
                       positions=positions, mode=mode, cache=cache,
                       plan=plan, nldpe=nldpe, dense_rows=dense_rows,
                       prefix_len=prefix_len)
    x = x + a.to(x.dtype)
    h2 = rmsnorm_apply(p["norm2"], x)
    if btype == "moe":
        f = moe_apply(p["ffn"], h2, cfg.moe, act=cfg.act, groups=groups,
                      nldpe=nldpe, drops=moe_drops, live=moe_live)
    else:
        f = mlp_apply(p["ffn"], h2, act=cfg.act, nldpe=nldpe, d_ff=cfg.d_ff)
    return x + f.to(x.dtype)


def _rwkv_block(p: dict, x: torch.Tensor, h: torch.Tensor, *, mode: str,
                cache, nldpe: NLDPEConfig) -> torch.Tensor:
    """RWKV6 time-mix and channel-mix over the normed ``h``.  The stack's
    float32 rows enter as ``repro``'s state would: float32 (the fresh
    state) in the whole-prompt prefill, in the activation dtype (the
    carried state) at decode."""
    tm_state, cm_x = None, None
    if cache is not None:
        dt = x.dtype if mode == "decode" else torch.float32
        tm_state = {"S": cache["tm"]["S"],
                    "x_last": cache["tm"]["x_last"].to(dt)}
        cm_x = cache["cm_x"].to(dt)
    a, st = timemix_apply(p["tm"], h, tm_state, mode=mode, nldpe=nldpe)
    x = x + a.to(x.dtype)
    h2 = rmsnorm_apply(p["norm2"], x)
    f, x_last = channelmix_apply(p["cm"], h2, cm_x, nldpe=nldpe)
    if cache is not None:
        cache["tm"]["S"].copy_(st["S"])
        cache["tm"]["x_last"].copy_(st["x_last"])
        cache["cm_x"].copy_(x_last)
    return x + f.to(x.dtype)


def forward(params: dict, tokens: torch.Tensor, cfg, *, mode: str = "chunk",
            cache: dict | None = None, positions: torch.Tensor | None = None,
            nldpe: NLDPEConfig = OFF, write_mask=None,
            moe_drops: torch.Tensor | None = None,
            moe_live: torch.Tensor | None = None,
            patch_embeds: torch.Tensor | None = None,
            batch_groups: int = 1, gather_vocab: bool = True
            ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) float32; ``cache`` updates in place.

    ``repro``'s modes: "train" (the whole sequence, differentiable, no
    cache), "prefill" (the whole prompt at positions (S,), default
    ``arange(S)``; fills a dense ``cache`` if one is given), "decode" and
    "chunk" (positions () shared for a lockstep cache, or (B, S) per-slot
    offsets; ``write_mask`` (B,) bool freezes masked slots' caches).
    ``moe_drops`` and ``moe_live`` (B, S) bool: see the module docstring.
    ``patch_embeds`` (B, P, d), "train" and "prefill" only, into no cache
    or a lockstep one: an image prefix before the tokens (the module
    docstring); the logits then cover P + S positions, at default
    positions ``arange(P + S)``.  ``batch_groups`` splits each MoE layer's
    tokens into that many routing groups (``nn.moe.moe_apply``).

    Under a sharding context (``parallel.context.sharding_ctx``) the
    tensors are this rank's shards: rows split over the rules' "batch"
    axes when the context names the global batch, heads, FFN columns and
    vocab rows over "model".  Each layer's leaves split over a batch axis
    (FSDP: "embed" over "data") are gathered at use when the context
    carries the parameters' ``specs`` (``parallel.context.
    gather_params``).  The attention and FFN layers gather at their
    contraction boundaries under the exact tables and all-reduce partial
    sums under ``train`` and ``serve``; the embedding is a vocab-parallel
    lookup.  The logits are this rank's rows: in "train" mode its vocab
    columns (``lm_loss`` takes them as they are), in the serve modes
    every column (gathered over the vocab axes: exact) unless
    ``gather_vocab`` is false (a caller that reads a few positions
    gathers those through ``vocab_gathered``).  Recurrent and
    RWKV6 blocks take no context (their contractions shard under every
    table; ROADMAP.md A.2 queue, item 3)."""
    if mode == "train":
        if nldpe.enabled and nldpe.fused_dual_compute:
            raise NotImplementedError(
                "training under FUSED numerics: kernels B and C have no "
                "backward, and no reference path trains through them "
                "(ROADMAP.md A)")
        if cache is not None:
            raise ValueError("mode='train' takes no cache")
    _check_cfg(cfg)
    ctx = current()
    if ctx is not None and any(t in ("rec", "rwkv")
                               for t in cfg.layer_pattern):
        raise NotImplementedError(
            f"{cfg.name}: recurrent and RWKV6 blocks do not run under a "
            f"mesh yet (their contractions shard under every rule table; "
            f"ROADMAP.md A.2 queue, item 3: RG-LRU and RWKV6 under a mesh)")
    specs = None if ctx is None else ctx.specs
    all_stacks = {} if cache is None else stacks(cache)
    attn_stacks = {} if cache is None else attention_stacks(cache)
    emb = _at_use(params, specs, "embed")
    x = embedding_apply(emb, tokens, dtype=cfg.activation_dtype,
                        vocab=cfg.vocab_size)
    if cfg.embed_scale:
        # repro rounds the scale to the activation dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    prefix_len = None
    if patch_embeds is not None:
        if mode not in ("train", "prefill") or any(
                "bt" in st or st["pos"].ndim != 1
                for st in attn_stacks.values()):
            raise ValueError(
                "patch_embeds: an image prefix is prefilled whole ('train' "
                "or 'prefill') into no cache or a lockstep one; paged and "
                "slotted caches take none, as repro's engines pass none")
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        prefix_len = patch_embeds.shape[1]
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    if moe_live is None and write_mask is not None:
        moe_live = write_mask[:, None].expand(tokens.shape)
    # a paged cache's write-masked slots (idle or finished) read, through
    # kernel A, another tenant's or no pages; their outputs are discarded,
    # except where an MoE layer may drop assignments for capacity: there
    # they compete for expert slots, so they must carry repro's values
    # (nn.attention.attn_apply).  Finding them syncs the device.
    dense_rows = None
    shards = 1 if ctx is None else ctx.batch_shards()
    if (write_mask is not None and cache is not None and "bt" in cache
            and "moe" in cfg.layer_pattern
            and may_drop(group_tokens(tokens.numel() * shards,
                                      batch_groups), cfg.moe)):
        dense_rows = torch.nonzero(~write_mask).flatten()
        if not dense_rows.numel():
            dense_rows = None
    plans = {name: write_plan(layer_cache(st, 0), positions, write_mask)
             for name, st in attn_stacks.items()}
    order = layer_order(cfg)
    slots = cache_slots(cfg)

    def layer(x, i):
        btype, where, key, g = order[i]
        st, j = slots[i]
        c = None
        if cache is not None:
            c = (_index(all_stacks[st], j) if st in ("rec", "rwkv")
                 else layer_cache(attn_stacks[st], j))
        p = params[where][key]
        p = p if g is None else _index(p, g)
        # the backward pass may recompute the layer on autograd's own
        # thread, where the forward's (thread-local) context is not set
        with installed(ctx):
            if specs is not None:
                p = gather_params(p, specs[where][key])
            return apply_block(p, cfg, btype, x,
                               positions=positions, mode=mode, cache=c,
                               plan=plans.get(st), nldpe=nldpe,
                               moe_drops=moe_drops, moe_live=moe_live,
                               dense_rows=dense_rows, prefix_len=prefix_len,
                               groups=batch_groups)

    remat = mode == "train" and cfg.scan_remat and torch.is_grad_enabled()
    for i in range(len(order)):
        x = (checkpoint(layer, x, i, use_reentrant=False) if remat
             else layer(x, i))
    x = rmsnorm_apply(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed_apply(emb, x, vocab=cfg.vocab_size)
    else:
        w = _at_use(params, specs, "lm_head")["w"]
        x = enter(x, "vocab", cfg.vocab_size, w.shape[-1])
        logits = x.to(torch.float32) @ w.to(torch.float32)
    if cfg.logit_softcap:
        logits = torch.tanh(scalar_div(logits, cfg.logit_softcap)) \
            * cfg.logit_softcap
    return (vocab_gathered(logits, cfg) if mode != "train" and gather_vocab
            else logits)


def vocab_gathered(logits: torch.Tensor, cfg) -> torch.Tensor:
    """Every vocab column of ``logits`` (..., V or this rank's vocab
    shard), concatenated over the rules' vocab axes under the current
    sharding context: exact."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return current().mesh.all_gather(logits, logits.dim() - 1,
                                     act_axes("vocab", cfg.vocab_size))


def _at_use(params: dict, specs, name: str) -> dict:
    """``params[name]`` with its FSDP-split leaves gathered (no-op
    without ``specs``)."""
    return (params[name] if specs is None
            else gather_params(params[name], specs[name]))


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            z_loss: float = 1e-4, vocab: int | None = None) -> torch.Tensor:
    """Mean token cross-entropy (+ z-loss) in float32.

    Under a sharding context, logits holding fewer than ``vocab`` columns
    are this rank's vocab shard: the log-sum-exp takes the max over the
    whole vocab (an all-reduce max, no gradient), then the sum of
    exponentials and the gold logit (read by the rank that holds it,
    zero elsewhere) are summed over the vocab axes
    (``parallel.context.reduce_partial``); the z-loss reads that global
    log-sum-exp.  The mean is over this rank's rows."""
    logits = logits.to(torch.float32)
    n = logits.shape[-1]
    if current() is None or vocab is None or n == vocab:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        mesh = current().mesh
        axes = act_axes("vocab", vocab)
        m = mesh.all_reduce(torch.amax(logits.detach(), dim=-1), axes,
                            op="max")
        s = reduce_partial(torch.sum(torch.exp(logits - m[..., None]),
                                     dim=-1), "vocab", vocab, n)
        lse = torch.log(s) + m
        t = labels.long() - mesh.position(axes) * n
        mine = (t >= 0) & (t < n)
        gold = torch.gather(logits, -1,
                            torch.clamp(t, 0, n - 1)[..., None])[..., 0]
        gold = reduce_partial(gold * mine, "vocab", vocab, n)
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse ** 2)
    return loss


def decode_step(params: dict, cfg, token: torch.Tensor, pos, cache: dict,
                nldpe: NLDPEConfig = OFF, write_mask=None,
                moe_drops: torch.Tensor | None = None,
                batch_groups: int = 1) -> torch.Tensor:
    """token (B,); pos () shared (lockstep cache) or (B,) per slot ->
    logits (B, V)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
    logits = forward(params, token[:, None], cfg, mode="decode", cache=cache,
                     positions=positions, nldpe=nldpe, write_mask=write_mask,
                     moe_drops=moe_drops, batch_groups=batch_groups)
    return logits[:, 0]
