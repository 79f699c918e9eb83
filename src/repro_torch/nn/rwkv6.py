"""RWKV-6 "Finch" block (arXiv:2404.05892; port of ``repro.nn.rwkv6``):
attention-free time-mix with a data-dependent decay, and channel-mix.

Time-mix recurrence per head (head size N = 64), state S in R^{N x N}:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          w_t = exp(-exp(ww_t))
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

r, k, v, the gate g and the decay ww are projections of token-shifted
inputs (lerps between x_t and x_{t-1}, ratios ``mu``); the decay goes
through a small LoRA.  Under NL-DPE numerics the lerps' and the gate's
products are log-domain DMMuls and the decay is two ACAM ``exp`` tables,
as in ``repro``; the WKV products themselves are plain float32, as there.

Two evaluation paths, as in ``repro``:

* ``_chunked_wkv`` (train, prefill): the sequence in chunks of ``chunk``
  positions — an attention-like intra-chunk term and the state passed
  between chunks, every decay exponential centred on the chunk's middle
  position so that no leg spans more than half the chunk's decay (float32
  overflows past ~88 nats).  ``repro`` halves its chunk until it divides
  the length (an odd length runs one position a step); the port keeps
  full chunks and a shorter last one, the same per-chunk math (the
  tolerance against ``repro`` is stated in ``tests/test_torch_rwkv6.py``);
* the decode step (mode "decode"): the recurrence above, one token.

State: ``{"S": (B, H, N, N) float32, "x_last": (B, d)}`` for the
time-mix and the channel-mix's ``x_last`` (B, d).  ``repro``'s fresh
state is float32 zeros and its carried ``x_last`` is in the activation
dtype, and the token shift promotes the lerps to the wider of the two
(JAX's and PyTorch's rules agree); callers pass the state in the dtype
``repro`` would hold it in.
"""
from __future__ import annotations

import torch

from ..core.engine import NLDPEConfig, OFF
from ..core.noise import clip

HEAD_SIZE = 64


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the promoted dtype of the two (``jnp.matmul``'s rule)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _token_shift(x: torch.Tensor, x_prev_last: torch.Tensor | None = None):
    """x_{t-1} along axis 1, the first row from the carried ``x_prev_last``
    (B, d) or zeros."""
    first = (torch.zeros_like(x[:, :1]) if x_prev_last is None
             else x_prev_last[:, None])
    dt = torch.promote_types(first.dtype, x.dtype)
    return torch.cat([first.to(dt), x[:, :-1].to(dt)], dim=1)


def _projections(p: dict, x: torch.Tensor, x_shift: torch.Tensor,
                 nldpe: NLDPEConfig):
    def mix(i):
        mu = p["mu"][i].to(x.dtype)
        return x + nldpe.elementwise_mul(mu * torch.ones_like(x),
                                         x_shift - x).to(x.dtype)

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    r = xr @ p["w_r"].to(x.dtype)
    k = xk @ p["w_k"].to(x.dtype)
    v = xv @ p["w_v"].to(x.dtype)
    g = nldpe.activation(xg @ p["w_g"].to(x.dtype), "silu")
    f32 = torch.float32
    lora = torch.tanh(xw.to(f32) @ p["decay_A"].to(f32))
    ww = p["decay_base"].to(f32) + lora @ p["decay_B"].to(f32)
    # Finch decay w = exp(-exp(ww)) in (0, 1): the ACAM exp twice when on
    if nldpe.enabled and nldpe.acam_activations:
        w = nldpe.activation(-nldpe.activation(ww, "exp"), "exp")
    else:
        w = torch.exp(-torch.exp(ww))
    return r, k, v, g, w


def _heads(x: torch.Tensor, b: int, s: int, d: int) -> torch.Tensor:
    return x.reshape(b, s, d // HEAD_SIZE, HEAD_SIZE).transpose(1, 2)


def timemix_apply(p: dict, x: torch.Tensor, state: dict | None = None,
                  mode: str = "train", chunk: int = 128,
                  nldpe: NLDPEConfig = OFF):
    """x (B, S, d); state ``{"S": (B, H, N, N), "x_last": (B, d)}`` or None
    (zeros) -> (y (B, S, d), new state ``{"S" float32, "x_last"}``)."""
    b, s, d = x.shape
    h = d // HEAD_SIZE
    x_last = None if state is None else state["x_last"]
    xs = _token_shift(x, x_last)
    r, k, v, g, w = _projections(p, x, xs, nldpe)
    f32 = torch.float32
    rh, kh, vh = _heads(r, b, s, d), _heads(k, b, s, d), _heads(v, b, s, d)
    wh = _heads(w.to(f32), b, s, d)
    u = p["bonus_u"].to(f32)
    s0 = (torch.zeros((b, h, HEAD_SIZE, HEAD_SIZE), dtype=f32,
                      device=x.device)
          if state is None else state["S"].to(f32))

    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one position, got {s}")
        rt, kt, vt, wt = (t[:, :, 0].to(f32) for t in (rh, kh, vh, wh))
        kv = kt[..., None] * vt[..., None, :]
        att = s0 + u[None, :, :, None] * kv
        o = (rt[:, :, None, :] @ att)[:, :, 0]
        s_new = wt[..., None] * s0 + kv
        out = o[:, :, None]
    else:
        out, s_new = _chunked_wkv(rh, kh, vh, wh, u, s0, chunk)

    out = out.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    out = nldpe.elementwise_mul(g, out).to(x.dtype)
    y = out @ p["w_o"].to(x.dtype)
    return y, {"S": s_new, "x_last": x[:, -1]}


def _chunk_step(S, rc, kc, vc, lwc, u):
    """One chunk (B, H, C, N) of WKV6 from state S (B, H, N, N): (its
    output, the state after it), float32, decays centred on the middle
    position."""
    c = rc.shape[2]
    cum = torch.cumsum(lwc, dim=2)                   # inclusive decay logs
    mid = cum[:, :, c // 2, :][:, :, None, :]
    d_excl = torch.exp(cum - lwc)                    # D_{t-1} (exclusive)
    o_inter = (rc * d_excl) @ S
    # intra-chunk: score_{t,j} = sum_n r_tn k_jn exp(cum_{t-1} - cum_j)
    q_dec = rc * torch.exp(cum - lwc - mid)
    k_dec = kc * torch.exp(mid - cum)
    scores = q_dec @ k_dec.transpose(-1, -2)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=rc.device), diagonal=-1)
    scores = torch.where(mask, scores, 0.0)
    diag = torch.sum(rc * u[None, :, None, :] * kc, dim=-1)  # bonus term
    o_intra = scores @ vc + diag[..., None] * vc
    last = cum[:, :, -1:, :]
    d_tail = torch.exp(last - mid) * torch.exp(mid - cum)    # prod_{i>j} w_i
    S_new = (torch.exp(cum[:, :, -1, :])[..., None] * S
             + (kc * d_tail).transpose(-1, -2) @ vc)
    return o_inter + o_intra, S_new


def _chunked_wkv(r, k, v, w, u, s0, chunk: int):
    """Chunk-parallel WKV6: r, k, v, w (B, H, S, N), s0 (B, H, N, N) ->
    (out (B, H, S, N), final state), float32."""
    f32 = torch.float32
    rf, kf, vf = r.to(f32), k.to(f32), v.to(f32)
    lw = torch.log(clip(w.to(f32), 1e-12, 1.0))
    S = s0
    outs = []
    for c0 in range(0, r.shape[2], chunk):
        sl = slice(c0, c0 + chunk)
        o, S = _chunk_step(S, rf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
                           lw[:, :, sl], u)
        outs.append(o)
    return torch.cat(outs, dim=2), S


def channelmix_apply(p: dict, x: torch.Tensor,
                     x_last: torch.Tensor | None = None,
                     nldpe: NLDPEConfig = OFF):
    """x (B, S, d) -> (y (B, S, d), x_last (B, d)): squared-ReLU key,
    sigmoid receptance."""
    xs = _token_shift(x, x_last)
    mu_k = p["mu"][0].to(x.dtype)
    mu_r = p["mu"][1].to(x.dtype)
    xk = x + mu_k * (xs - x)
    xr = x + mu_r * (xs - x)
    hk = nldpe.activation(_mm(xk, p["w_k"].to(x.dtype)), "relu")
    hk = nldpe.elementwise_mul(hk, hk).to(x.dtype)            # relu^2
    v = hk @ p["w_v"].to(x.dtype)
    r = nldpe.activation(_mm(xr, p["w_r"].to(x.dtype)), "sigmoid")
    return nldpe.elementwise_mul(r, v).to(x.dtype), x[:, -1]


def rwkv_state_init(batch: int, d: int, *, layers: int | None = None,
                    device=None) -> dict:
    """Zero RWKV6 block state, float32, with a leading axis of ``layers``
    when given (a stack): ``{"tm": {"S": (B, H, N, N), "x_last": (B, d)},
    "cm_x": (B, d)}``."""
    lead = () if layers is None else (layers,)
    z = dict(dtype=torch.float32, device=device)
    return {"tm": {"S": torch.zeros((*lead, batch, d // HEAD_SIZE,
                                     HEAD_SIZE, HEAD_SIZE), **z),
                   "x_last": torch.zeros((*lead, batch, d), **z)},
            "cm_x": torch.zeros((*lead, batch, d), **z)}
