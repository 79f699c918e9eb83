"""Decoder-only LM of the ``("attn",)`` layer pattern (port of the serving
and training parts of ``repro.models.lm``).

Parameters keep ``repro``'s tree, names and stacked ``"groups"`` layout
(leading axis = layer), so ``convert.from_jax`` maps one onto the other
leaf by leaf.  Where ``repro`` scans over the stacked groups, the port
loops over layers in Python.

The model cache stacks every layer's K/V on a leading layer axis and keeps
ONE position track (and, paged, one block table) — ``repro`` keeps a copy
of each per layer, but every layer's copy holds the same values:

* lockstep ``{"k", "v", "pos"}``: K/V (L, B, Hkv, max_len, D), pos
  (max_len,);
* slotted: the same with pos (B, max_len);
* paged ``{"k", "v", "pos", "bt"}``: pools (L, P, Hkv, page_size, D), pos
  (B, max_len), block table (B, NB).

A config whose ``kv_cache_dtype`` is "int8" or "log8" gets quantized
caches: K/V hold int8 codes and ``k_scale``/``v_scale`` one float32 scale
per position and head, stacked on the same leading layer axis.

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
from ..core.quantization import KV_QUANT_MODES
from ..nn.attention import (AttnSpec, attn_apply, init_cache, kv_leaves,
                            write_plan)
from ..nn.basic import embedding_apply, rmsnorm_apply, unembed_apply
from ..nn.mlp import mlp_apply


def kv_quant_of(cfg) -> str | None:
    """The KV storage grid ``cfg.kv_cache_dtype`` names, or None (fp)."""
    return (cfg.kv_cache_dtype if cfg.kv_cache_dtype in KV_QUANT_MODES
            else None)


def attn_spec(cfg) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                    kv_quant=kv_quant_of(cfg))


def _check_cfg(cfg) -> None:
    bad = [t for t in cfg.layer_pattern if t != "attn"]
    if bad or cfg.window or cfg.qk_norm or cfg.attn_softcap \
            or cfg.logit_softcap or cfg.embed_scale:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the plain ('attn',) pattern only "
            f"(no windows, qk-norm, softcaps or embedding scale)")


def init_params(cfg, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters with ``repro``'s tree and init distributions
    (``nn/module.py:58``): normal scaled by fan_in^-1/2 for projections,
    0.02 for the embedding, (Hq*Dh)^-1/2 for the output projection, zero
    biases and unit norm scales.  Drawn from ``generator`` on ``device``
    (the card unless ``device="cpu"``)."""
    _check_cfg(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    d, n = cfg.d_model, cfg.n_layers
    s = attn_spec(cfg)

    def normal(shape, scale):
        x = torch.randn((n, *shape), generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale)

    def const(shape, value, layers=True):
        return torch.full(((n,) if layers else ()) + tuple(shape), value,
                          dtype=torch.float32, device=device)

    attn = {"wq": normal((d, s.n_heads, s.head_dim), d ** -0.5),
            "wk": normal((d, s.n_kv_heads, s.head_dim), d ** -0.5),
            "wv": normal((d, s.n_kv_heads, s.head_dim), d ** -0.5),
            "wo": normal((s.n_heads, s.head_dim, d),
                         (s.n_heads * s.head_dim) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=const((s.n_heads, s.head_dim), 0.0),
                    bk=const((s.n_kv_heads, s.head_dim), 0.0),
                    bv=const((s.n_kv_heads, s.head_dim), 0.0))
    ffn = {"up": normal((d, cfg.d_ff), d ** -0.5),
           "down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}
    if cfg.gated_mlp:
        ffn["gate"] = normal((d, cfg.d_ff), d ** -0.5)
    table = torch.randn((cfg.vocab_size, d), generator=generator,
                        device=device, dtype=torch.float32).mul_(0.02)
    params = {"embed": {"table": table},
              "groups": {"b0": {"norm1": {"scale": const((d,), 1.0)},
                                "norm2": {"scale": const((d,), 1.0)},
                                "attn": attn, "ffn": ffn}},
              "final_norm": {"scale": const((d,), 1.0, layers=False)}}
    if not cfg.tie_embeddings:
        w = torch.randn((d, cfg.vocab_size), generator=generator,
                        device=device, dtype=torch.float32) * d ** -0.5
        params["lm_head"] = {"w": w}
    return params


def serving_params(params: dict, cfg, nldpe: NLDPEConfig = OFF) -> dict:
    """The parameter tree a server runs from: every matmul weight and bias
    cast once to the activation dtype — the values ``x @ w.astype(x.dtype)``
    gives per call in ``repro`` — except the MLP gate under ``FUSED``,
    which the crossbar->ACAM kernel programs from the float32 master."""
    act = cfg.activation_dtype
    blk = params["groups"]["b0"]
    fused = (nldpe.enabled and nldpe.acam_activations
             and nldpe.fused_dual_compute)
    ffn = {k: (v if k == "gate" and fused else v.to(act))
           for k, v in blk["ffn"].items()}
    out = dict(params)
    out["groups"] = {"b0": dict(blk, ffn=ffn, attn={
        k: v.to(act) for k, v in blk["attn"].items()})}
    return out


def init_model_cache(cfg, batch: int, max_len: int, *,
                     paged: tuple[int, int] | None = None,
                     slotted: bool = False, dtype=torch.float32,
                     device=None) -> dict:
    """Every layer's cache: dense lockstep (default), dense ``slotted``, or
    ``paged=(num_pages, page_size)`` (unmapped block-table entries hold the
    sentinel ``num_pages``); int8 codes and float32 scales in place of
    ``dtype`` values when ``cfg.kv_cache_dtype`` names a grid."""
    _check_cfg(cfg)
    device = resolve_device(device)
    s = attn_spec(cfg)
    if paged is None:
        return init_cache(s, batch, max_len, layers=cfg.n_layers,
                          dtype=dtype, slotted=slotted, device=device)
    num_pages, page_size = paged
    kv = (cfg.n_layers, num_pages, s.n_kv_heads, page_size, s.head_dim)
    n_blocks = -(-max_len // page_size)
    cache = kv_leaves(kv, dtype, s.kv_quant, device)
    cache["pos"] = torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device)
    cache["bt"] = torch.full((batch, n_blocks), num_pages, dtype=torch.int32,
                             device=device)
    return cache


POOL_LEAVES = ("k", "v", "k_scale", "v_scale")


def layer_cache(cache: dict, i: int) -> dict:
    """Layer ``i``'s view of the model cache (K/V and scales are views:
    writes land in the model cache)."""
    return dict(cache, **{n: cache[n][i] for n in POOL_LEAVES if n in cache})


def forward(params: dict, tokens: torch.Tensor, cfg, *, mode: str = "chunk",
            cache: dict | None = None, positions: torch.Tensor | None = None,
            nldpe: NLDPEConfig = OFF, write_mask=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) float32; ``cache`` updates in place.

    ``repro``'s modes: "train" (the whole sequence, differentiable, no
    cache), "prefill" (the whole prompt at positions (S,), default
    ``arange(S)``; fills a dense ``cache`` if one is given), "decode" and
    "chunk" (positions () shared for a lockstep cache, or (B, S) per-slot
    offsets; ``write_mask`` (B,) bool freezes masked slots' caches)."""
    if mode == "train":
        if nldpe.enabled and nldpe.fused_dual_compute:
            raise NotImplementedError(
                "training under FUSED numerics: kernels B and C have no "
                "backward, and no reference path trains through them "
                "(ROADMAP.md A)")
        if cache is not None:
            raise ValueError("mode='train' takes no cache")
    spec = attn_spec(cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    x = embedding_apply(params["embed"], tokens, dtype=cfg.activation_dtype)
    plan = None
    if cache is not None:
        plan = write_plan(layer_cache(cache, 0), positions, write_mask)
    blocks = params["groups"]["b0"]

    def layer(x, i):
        p = {k: {n: t[i] for n, t in v.items()} for k, v in blocks.items()}
        h = rmsnorm_apply(p["norm1"], x)
        a = attn_apply(p["attn"], spec, h, positions=positions, mode=mode,
                       cache=None if cache is None else layer_cache(cache, i),
                       plan=plan, nldpe=nldpe)
        x = x + a.to(x.dtype)
        h2 = rmsnorm_apply(p["norm2"], x)
        return x + mlp_apply(p["ffn"], h2, act=cfg.act,
                             nldpe=nldpe).to(x.dtype)

    remat = mode == "train" and cfg.scan_remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        x = (checkpoint(layer, x, i, use_reentrant=False) if remat
             else layer(x, i))
    x = rmsnorm_apply(params["final_norm"], x)
    if cfg.tie_embeddings:
        return unembed_apply(params["embed"], x)
    return x.to(torch.float32) @ params["lm_head"]["w"].to(torch.float32)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy (+ z-loss) in float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse ** 2)
    return loss


def decode_step(params: dict, cfg, token: torch.Tensor, pos, cache: dict,
                nldpe: NLDPEConfig = OFF, write_mask=None) -> torch.Tensor:
    """token (B,); pos () shared (lockstep cache) or (B,) per slot ->
    logits (B, V)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
    logits = forward(params, token[:, None], cfg, mode="decode", cache=cache,
                     positions=positions, nldpe=nldpe, write_mask=write_mask)
    return logits[:, 0]
