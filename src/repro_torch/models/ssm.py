"""SSM blocks: Mamba2 (SSD, chunked) and RWKV6 (Finch, data-dependent
decay), as in ``repro.models.ssm``.

Both are *chunked linear attention*, so the sequence dimension runs as
matmuls:

  Mamba2 state:  S_t = a_t * S_{t-1} + (dt_t x_t) B_t^T   (a scalar/head)
  RWKV6 state:   S_t = diag(w_t) S_{t-1} + k_t v_t^T      (w vector/key)

Within a chunk of Q tokens all pairwise decay products are exponentials of
cumulative-log-decay differences: for Mamba the exponents are always <= 0
(segsum form, no overflow); for RWKV's per-channel decay the factored
matmul form needs exp(-cumsum) on the key side, so the per-token log decay
is clamped to >= -DECAY_CLAMP and the chunk kept small enough that
exp(DECAY_CLAMP * Q) stays in f32 range (up to exp(57.6) ~ 1e25: these
products must run in f32, never under TF32). The decode path and the test
oracle use the *same* clamped decay, so chunked == recurrent up to f32
rounding.

The f32 casts sit where the reference has them, and the bf16 rounding
points are the reference's: ``decay_base + lora`` is added in the model
dtype, ``u = xin * dt`` and ``mix * (xx - x)`` run in it, ``D`` is cast
to it, and the gated RMS norm runs in f32 against the model-dtype
``norm``. The chunk-level state recurrence (``lax.scan`` there) is a
Python loop over chunks here. Mixed-dtype einsums of the reference
(which promotes to f32) cast their operands to f32 first; the reference's
multi-operand einsums may contract in another order, so parity is to a
tolerance.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig

DECAY_CLAMP = 1.8      # |log w| cap; exp(1.8 * 32) < f32 max


def _pad_seq(a: torch.Tensor, pad: int) -> torch.Tensor:
    """``a`` with ``pad`` zero rows appended along the sequence axis 1."""
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])], 1)


def _scan_states(init: torch.Tensor, decay: torch.Tensor,
                 inject: torch.Tensor):
    """The chunk-level recurrence S_t = S_{t-1} * decay_t + inject_t over
    axis 1 of ``decay``/``inject`` (``decay`` already broadcast to the
    state's trailing axes). Returns (final state, (B, nc, ...) start state
    of each chunk)."""
    starts = []
    state = init
    for t in range(inject.shape[1]):
        starts.append(state)
        state = state * decay[:, t] + inject[:, t]
    return state, torch.stack(starts, 1)


# ===========================================================================
# Mamba2 SSD core
# ===========================================================================

def ssd_chunked(u: torch.Tensor, logdecay: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                s0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B,S,H,P) inputs (dt*x); logdecay: (B,S,H) <=0; b,c: (B,S,N).

    Returns y (B,S,H,P), final state (B,H,P,N)."""
    bsz, s_orig, h, p = u.shape
    pad = (-s_orig) % chunk
    if pad:   # no-op tail: decay=1 (log 0), zero inputs -> state unchanged
        u, logdecay, b, c = (_pad_seq(a, pad) for a in (u, logdecay, b, c))
    s = u.shape[1]
    n = b.shape[-1]
    nc = s // chunk
    uc = u.reshape(bsz, nc, chunk, h, p)
    ld = logdecay.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(ld, dim=2)                       # inclusive (B,nc,Q,H)
    uf = uc.to(torch.float32)

    # intra-chunk: att[b,t,h,i,j] = (c_i . b_j) exp(cum_i - cum_j), j<=i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=u.device))
    # masked before the exp, not after as in the reference: the same
    # values, but exp(diff) of the upper triangle overflows to inf once a
    # chunk's decays sum past ~88, and the reference's gradient there is
    # inf * 0 = NaN; exp(-inf) = 0 has a zero gradient
    dec = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                float("-inf")))
    cb = torch.einsum("btin,btjn->btij", cc, bc)           # (B,nc,Q,Q)
    att = cb[..., None] * dec                              # (B,nc,Q,Q,H)
    y_intra = torch.einsum("btijh,btjhp->btihp", att, uf)

    # chunk-level state recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    # state injected by chunk t: sum_j exp(cum_last - cum_j) u_j b_j^T
    w_in = torch.exp(cum[:, :, -1:, :] - cum)              # (B,nc,Q,H)
    s_in = torch.einsum("btjh,btjhp,btjn->bthpn", w_in, uf,
                        bc.to(torch.float32))              # (B,nc,H,P,N)
    init = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                       device=u.device) if s0 is None \
        else s0.to(torch.float32)
    s_last, s_starts = _scan_states(init, chunk_decay[..., None, None],
                                    s_in)

    # carry-in contribution: y_i += (c_i exp(cum_i)) . S_start
    w_carry = torch.exp(cum)                               # (B,nc,Q,H)
    y_carry = torch.einsum("btin,btih,bthpn->btihp",
                           cc.to(torch.float32), w_carry, s_starts)
    y = (y_intra + y_carry).reshape(bsz, s, h, p)[:, :s_orig]
    return y.to(u.dtype), s_last


def ssd_step(s_prev: torch.Tensor, u_t: torch.Tensor,
             logdecay_t: torch.Tensor, b_t: torch.Tensor,
             c_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. s_prev (B,H,P,N); u_t (B,H,P); ld (B,H);
    b_t,c_t (B,N)."""
    a = torch.exp(logdecay_t.to(torch.float32))[..., None, None]
    s_new = s_prev * a + torch.einsum(
        "bhp,bn->bhpn", u_t.to(torch.float32), b_t.to(torch.float32))
    y = torch.einsum("bhpn,bn->bhp", s_new, c_t.to(torch.float32))
    return y.to(u_t.dtype), s_new


def ssd_recurrent_ref(u, logdecay, b, c, s0=None):
    """Naive per-token oracle for ssd_chunked (tests)."""
    bsz, s, h, p = u.shape
    n = b.shape[-1]
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=u.device) if s0 is None else s0
    ys = []
    for t in range(s):
        y, state = ssd_step(state, u[:, t], logdecay[:, t], b[:, t],
                            c[:, t])
        ys.append(y)
    return torch.stack(ys, 1)


# ===========================================================================
# RWKV6 linear-attention core
# ===========================================================================

def rwkv_chunked(r, k, v, logw, bonus, chunk,
                 s0: Optional[torch.Tensor] = None):
    """r,k: (B,S,H,K); v: (B,S,H,V); logw: (B,S,H,K) in [-DECAY_CLAMP,0];
    bonus u: (H,K). Returns y (B,S,H,V), final state (B,H,K,V).

    y_i = r_i . S_{i-1} + (r_i . (u*k_i)) v_i ;  S_i = diag(w_i) S_{i-1}
          + k_i v_i^T
    """
    bsz, s_orig, h, dk = r.shape
    pad = (-s_orig) % chunk
    if pad:   # no-op tail: decay=1, zero r/k/v -> state unchanged
        r, k, v, logw = (_pad_seq(a, pad) for a in (r, k, v, logw))
    s = r.shape[1]
    dv = v.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    rc = r.reshape(bsz, nc, chunk, h, dk).to(f32)
    kc = k.reshape(bsz, nc, chunk, h, dk).to(f32)
    vc = v.reshape(bsz, nc, chunk, h, dv).to(f32)
    lw = logw.reshape(bsz, nc, chunk, h, dk)
    cum = torch.cumsum(lw, dim=2)                           # (B,nc,Q,H,K)
    cum_prev = cum - lw                                 # exclusive: c_{i-1}

    r_dec = rc * torch.exp(cum_prev)                        # r_i * e^{c_{i-1}}
    k_dec = kc * torch.exp(-cum)                            # k_j * e^{-c_j}
    att = torch.einsum("btihk,btjhk->bthij", r_dec, k_dec)  # j<i strict
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    att = torch.where(mask[None, None, None], att, 0.0)
    diag = torch.einsum("btihk,hk,btihk->bthi", rc, bonus.to(f32), kc)
    att = att + torch.eye(chunk, dtype=f32, device=r.device)[
        None, None, None] * diag[..., None]
    y_intra = torch.einsum("bthij,btjhv->btihv", att, vc)

    chunk_decay = torch.exp(cum[:, :, -1])                  # (B,nc,H,K)
    w_in = torch.exp(cum[:, :, -1:, :, :] - cum)            # (B,nc,Q,H,K)
    s_in = torch.einsum("btjhk,btjhv->bthkv", kc * w_in, vc)  # (B,nc,H,K,V)
    init = torch.zeros((bsz, h, dk, dv), dtype=f32, device=r.device) \
        if s0 is None else s0.to(f32)
    s_last, s_starts = _scan_states(init, chunk_decay[..., None], s_in)

    y_carry = torch.einsum("btihk,bthkv->btihv", r_dec, s_starts)
    y = (y_intra + y_carry).reshape(bsz, s, h, dv)[:, :s_orig]
    return y.to(r.dtype), s_last


def rwkv_step(s_prev, r_t, k_t, v_t, logw_t, bonus):
    """Decode step. s_prev (B,H,K,V); r,k (B,H,K); v (B,H,V); logw (B,H,K)."""
    rf, kf, vf = (a.to(torch.float32) for a in (r_t, k_t, v_t))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum(
        "bhk,bhkv->bhv", rf,
        s_prev + bonus.to(torch.float32)[None, :, :, None] * kv)
    s_new = s_prev * torch.exp(logw_t.to(torch.float32))[..., None] + kv
    return y.to(r_t.dtype), s_new


def rwkv_recurrent_ref(r, k, v, logw, bonus, s0=None):
    """Naive per-token oracle for rwkv_chunked (tests)."""
    bsz, s, h, dk = r.shape
    dv = v.shape[-1]
    state = torch.zeros((bsz, h, dk, dv), dtype=torch.float32,
                        device=r.device) if s0 is None else s0
    ys = []
    for t in range(s):
        y, state = rwkv_step(state, r[:, t], k[:, t], v[:, t], logw[:, t],
                             bonus)
        ys.append(y)
    return torch.stack(ys, 1)


# ===========================================================================
# Full blocks (pre-norm residual wrappers live in transformer.py)
# ===========================================================================

def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` with the reference's rounding: XLA expands the
    logistic into exp, add and divide, each rounded to a bf16 input's
    dtype (bit-equal on the CPU); in f32 ``torch.sigmoid`` is the closer
    spelling."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` = x * sigmoid(x), the product rounded on its own
    (``F.silu`` rounds once)."""
    return x * _sigmoid(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, window W. x (B,S,C); w (W,C).
    state (B,W-1,C) from previous tokens; returns (y, new_state).

    The reference's sum of W products in the model dtype, in order (a
    ``conv1d`` would accumulate in f32 and give other bits)."""
    win = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], win - 1, x.shape[-1]))
    xp = torch.cat([state, x], dim=1)                      # (B, S+W-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(win))
    return y, xp[:, -(win - 1):]


def mamba2_block(p: Dict, x: torch.Tensor, scfg: SSMConfig,
                 cache: Optional[Dict] = None):
    """x: (B,S,d). cache (decode): {"state": (B,H,P,N), "conv": (B,3,C)}.
    Returns (y, new cache {"state", "conv"})."""
    bsz, s, d = x.shape
    di = scfg.expand * d
    n = scfg.state_dim
    h = di // scfg.head_dim
    proj = x @ p["w_in"]                                   # (B,S,2di+2N+h)
    xin, z, bmat, cmat, dt = torch.split(proj, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv"], conv_state)
    conv_out = _silu(conv_out)
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    dt = dt.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))         # softplus, (B,S,H)
    a = -torch.exp(p["A_log"].to(torch.float32))           # (H,) < 0
    logdecay = torch.clamp(dt * a, min=-DECAY_CLAMP * 4)
    u = xin.reshape(bsz, s, h, scfg.head_dim) * dt[..., None].to(x.dtype)

    if cache is not None and s == 1:      # decode step
        y, s_new = ssd_step(cache["state"], u[:, 0], logdecay[:, 0],
                            bmat[:, 0], cmat[:, 0])
        y = y[:, None]
    else:                                 # train / prefill (chunked)
        s0 = cache["state"] if cache is not None else None
        y, s_new = ssd_chunked(u, logdecay, bmat, cmat,
                               min(scfg.chunk_size, s), s0=s0)
    new_cache = {"state": s_new, "conv": new_conv}
    y = y + xin.reshape(bsz, s, h, scfg.head_dim) \
        * p["D"].to(x.dtype)[:, None]
    y = y.reshape(bsz, s, di) * _silu(z)
    # final rms norm over the inner dim (mamba2 gated norm)
    yf = y.to(torch.float32)
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
         * p["norm"]).to(x.dtype)
    return y @ p["w_out"], new_cache


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """xx_t = x_{t-1}; prev (B,d) is the last token of the previous call."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None], x[:, :-1]], dim=1), x[:, -1]


def rwkv6_timemix(p: Dict, x: torch.Tensor, scfg: SSMConfig,
                  cache: Optional[Dict] = None):
    """Returns (y, new cache {"state", "x_att"})."""
    bsz, s, d = x.shape
    hd = scfg.head_dim
    h = d // hd
    prev = cache["x_att"] if cache is not None else None
    xx, last = _token_shift(x, prev)
    mix = p["mix"]                                           # (5, d)
    xr, xk, xv, xg, xw = (x + mix[i] * (xx - x) for i in range(5))
    r = (xr @ p["w_r"]).reshape(bsz, s, h, hd)
    k = (xk @ p["w_k"]).reshape(bsz, s, h, hd)
    v = (xv @ p["w_v"]).reshape(bsz, s, h, hd)
    g = _silu(xg @ p["w_g"])
    # data-dependent decay (LoRA): logw in [-DECAY_CLAMP, 0)
    lora = torch.tanh(xw @ p["decay_lora_a"]) @ p["decay_lora_b"]
    logw = -DECAY_CLAMP * _sigmoid(
        (p["decay_base"] + lora).to(torch.float32))
    logw = logw.reshape(bsz, s, h, hd)

    if cache is not None and s == 1:      # decode step
        y, s_new = rwkv_step(cache["state"], r[:, 0], k[:, 0], v[:, 0],
                             logw[:, 0], p["bonus"])
        y = y[:, None]
    else:                                 # train / prefill (chunked)
        s0 = cache["state"] if cache is not None else None
        y, s_new = rwkv_chunked(r, k, v, logw, p["bonus"],
                                min(scfg.chunk_size, 32, s), s0=s0)
    # per-head group norm (ln_x), population variance as in jnp.var
    yf = y.reshape(bsz, s, h, hd).to(torch.float32)
    yf = (yf - yf.mean(-1, keepdim=True)) \
        * torch.rsqrt(yf.var(-1, keepdim=True, correction=0) + 1e-5)
    yf = yf.reshape(bsz, s, d) * p["ln_x"].to(torch.float32)
    out = (yf.to(x.dtype) * g) @ p["w_o"]
    return out, {"state": s_new, "x_att": last}


def rwkv6_channelmix(p: Dict, x: torch.Tensor,
                     cache: Optional[Dict] = None):
    """Returns (y, new cache {"x_ffn"})."""
    prev = cache["x_ffn"] if cache is not None else None
    xx, last = _token_shift(x, prev)
    mix = p["ffn_mix"]
    xk = x + mix[0] * (xx - x)
    xr = x + mix[1] * (xx - x)
    k = torch.square(F.relu(xk @ p["ffn_k"]))
    r = _sigmoid(xr @ p["ffn_r"])
    return r * (k @ p["ffn_v"]), {"x_ffn": last}
