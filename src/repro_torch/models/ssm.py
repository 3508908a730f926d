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
from repro_torch.dist import sharding as SH

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


def _mamba2_inner(p: Dict, proj: torch.Tensor, scfg: SSMConfig,
                  cache: Optional[Dict], heads: slice):
    """Mamba2 from the input projection ``proj`` (B,S,2di+2N+H) to the
    gated output before its norm, for the heads ``heads`` (all of them on
    one device, a model rank's own in :func:`mamba2_block_split`): their
    ``xin``/``z`` channels and ``dt``, and the whole ``B`` and ``C``. The
    conv and ``D`` are per channel, the scan per head. Returns (y (B,S,
    channels) in the model dtype, the heads' new state, the new conv rows
    of every channel)."""
    bsz, s, _ = proj.shape
    hd, n = scfg.head_dim, scfg.state_dim
    h = p["D"].shape[0]
    di = h * hd
    hs = range(h)[heads]
    ch = slice(hs.start * hd, hs.stop * hd)
    xin_all, _, bc, dt = torch.split(proj, [di, di, 2 * n, h], dim=-1)
    z = proj[..., di + ch.start:di + ch.stop]
    conv_state = cache["conv"] if cache is not None else None
    if hs.stop - hs.start == h:           # every channel: the whole conv
        conv_out, new_conv = _causal_conv(torch.cat([xin_all, bc], -1),
                                          p["conv"], conv_state)
    else:                                 # this rank's channels, B and C
        def keep(a):
            return torch.cat([a[..., ch], a[..., di:]], -1)
        conv_out, _ = _causal_conv(
            torch.cat([xin_all[..., ch], bc], -1), keep(p["conv"]),
            None if conv_state is None else keep(conv_state))
        new_conv = None
        if conv_state is not None:        # every channel's last inputs
            new_conv = torch.cat([conv_state, torch.cat([xin_all, bc], -1)],
                                 1)[:, 1 - p["conv"].shape[0]:]
    conv_out = _silu(conv_out)
    cl = ch.stop - ch.start
    xin, bmat, cmat = torch.split(conv_out, [cl, n, n], dim=-1)

    dt = dt[..., heads].to(torch.float32) + p["dt_bias"][heads]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))         # softplus, (B,S,H)
    a_log = p["A_log"]      # (H,), or one per layer (the reference's init)
    a = -torch.exp((a_log[heads] if a_log.ndim else a_log).to(torch.float32))
    logdecay = torch.clamp(dt * a, min=-DECAY_CLAMP * 4)
    hl = len(hs)
    u = xin.reshape(bsz, s, hl, hd) * dt[..., None].to(proj.dtype)

    if cache is not None and s == 1:      # decode step
        y, s_new = ssd_step(cache["state"][:, heads], u[:, 0],
                            logdecay[:, 0], bmat[:, 0], cmat[:, 0])
        y = y[:, None]
    else:                                 # train / prefill (chunked)
        s0 = cache["state"][:, heads] if cache is not None else None
        y, s_new = ssd_chunked(u, logdecay, bmat, cmat,
                               min(scfg.chunk_size, s), s0=s0)
    y = y + xin.reshape(bsz, s, hl, hd) \
        * p["D"][heads].to(proj.dtype)[:, None]
    return y.reshape(bsz, s, cl) * _silu(z), s_new, new_conv


def mamba2_block(p: Dict, x: torch.Tensor, scfg: SSMConfig,
                 cache: Optional[Dict] = None):
    """x: (B,S,d). cache (decode): {"state": (B,H,P,N), "conv": (B,3,C)}.
    Returns (y, new cache {"state", "conv"})."""
    y, s_new, new_conv = _mamba2_inner(p, x @ p["w_in"], scfg, cache,
                                       slice(None))
    # final rms norm over the inner dim (mamba2 gated norm)
    yf = y.to(torch.float32)
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
         * p["norm"]).to(x.dtype)
    return y @ p["w_out"], {"state": s_new, "conv": new_conv}


def mamba2_block_split(ps, xs, scfg: SSMConfig, caches, split: "SH.Split"):
    """:func:`mamba2_block` per mesh position (``dist.sharding.Split``):
    ``ps``, ``xs`` (B_i, S, d) and ``caches`` (each position's {state,
    conv} of its data rank's rows, every head and channel; ``None``: no
    cache) are per-position lists. Returns (the outputs, the new caches
    or ``None``).

    ``w_in``'s column shards (911 of Zamba2's 14,576 columns at 16 ranks)
    cross the ``xin | z | B | C | dt`` boundaries, so the projection is
    all-gathered over model (an activation, never the weight). Where the
    heads divide the model axis, rank j then runs heads slice j: its
    ``xin``, ``z`` and ``dt`` and the whole ``B`` and ``C``, its channels
    of the depthwise conv, the scan and ``D``; the gated RMS norm over the
    whole inner dim closes its f32 sum of squares with the model sum, and
    the rank's channels times ``w_out``'s row shard are a partial product
    closed by the model sum. The new state slices are all-gathered before
    the cache write (every rank holds all of its rows' heads, as the
    reference's ``cache_specs`` places them); each rank has every
    channel's conv inputs from the gathered projection. Where the heads do
    not divide, every rank runs every head and closes ``w_out`` with its
    row slice."""
    groups, devs, m = split.model_groups, split.devices, split.msize
    h = ps[0]["D"].shape[0]
    di = h * scfg.head_dim
    nin = 2 * di + 2 * scfg.state_dim + h
    heads = m > 1 and h % m == 0
    out_split = ps[0]["w_out"].shape[0] < di
    proj = split.each(lambda p, x, w: x @ w["w_in"], xs, ps)
    if ps[0]["w_in"].shape[-1] < nin:
        proj = SH.all_gather(proj, groups, devs, -1)

    def inner(p, w, pr, cache):
        hl = h // m if heads else h
        j = split.rank[p] if heads else 0
        return _mamba2_inner(w, pr, scfg, cache, slice(j * hl, (j + 1) * hl))

    done = split.each(inner, ps, proj, caches or [None] * split.n)
    yf = split.each(lambda p, d: d[0].to(torch.float32), done)
    # the sum of squares reads f once (``square``): f's gradient is then
    # two terms, whose sum is the same whichever sum's backward runs first
    ss = split.each(lambda p, f: torch.square(f).sum(-1, keepdim=True), yf)
    if heads:                 # the norm's sum of squares over the ranks
        ss = SH.all_reduce(ss, groups, devs)

    def close(p, f, q, w, d):
        c, j = f.shape[-1], split.rank[p]
        first = j * c if heads else 0
        y = (f * torch.rsqrt(q / di + 1e-6)
             * w["norm"][first:first + c]).to(d[0].dtype)
        if out_split and not heads:       # this rank's rows of w_out
            r = w["w_out"].shape[0]
            y = y[..., j * r:(j + 1) * r]
        return y @ w["w_out"]

    outs = split.each(close, yf, ss, ps, done)
    if out_split:
        outs = SH.all_reduce(outs, groups, devs)
    if caches is None:
        return outs, None
    states = [s for _, s, _ in done]
    if heads:
        states = SH.all_gather(states, groups, devs, 1)
    return outs, [{"state": st, "conv": cv}
                  for st, (_, _, cv) in zip(states, done)]


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
    mixed, last = _mixes(x, p["mix"], cache["x_att"] if cache is not None
                         else None)                          # mix (5, d)
    xr, xk, xv, xg, xw = mixed.unbind(0)
    r = (xr @ p["w_r"]).reshape(bsz, s, h, hd)
    k = (xk @ p["w_k"]).reshape(bsz, s, h, hd)
    v = (xv @ p["w_v"]).reshape(bsz, s, h, hd)
    g = _silu(xg @ p["w_g"])
    # data-dependent decay (LoRA): logw in [-DECAY_CLAMP, 0)
    lora = torch.tanh(xw @ p["decay_lora_a"]) @ p["decay_lora_b"]
    logw = -DECAY_CLAMP * _sigmoid(
        (p["decay_base"] + lora).to(torch.float32))
    logw = logw.reshape(bsz, s, h, hd)

    yf, s_new = _rwkv_heads(r, k, v, logw, p["bonus"], p["ln_x"], scfg,
                            None if cache is None else cache["state"])
    out = (yf.to(x.dtype) * g) @ p["w_o"]
    return out, {"state": s_new, "x_att": last}


def _rwkv_heads(r, k, v, logw, bonus, ln_x, scfg: SSMConfig, state):
    """RWKV6's heads from r, k, v, logw (B,S,H,hd) and their ``bonus``,
    from ``state`` (B,H,K,V) or zeros: the recurrence (a decode step at
    S == 1 with a state, else chunked) and the per-head group norm
    (``ln_x``, population variance as in ``jnp.var``). Returns (the
    normed output (B,S,H*hd) f32, the new state)."""
    bsz, s, h, hd = r.shape
    if state is not None and s == 1:      # decode step
        y, s_new = rwkv_step(state, r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                             bonus)
        y = y[:, None]
    else:                                 # train / prefill (chunked)
        y, s_new = rwkv_chunked(r, k, v, logw, bonus,
                                min(scfg.chunk_size, 32, s), s0=state)
    yf = y.reshape(bsz, s, h, hd).to(torch.float32)
    yf = (yf - yf.mean(-1, keepdim=True)) \
        * torch.rsqrt(yf.var(-1, keepdim=True, correction=0) + 1e-5)
    return yf.reshape(bsz, s, h * hd) * ln_x.to(torch.float32), s_new


def rwkv6_channelmix(p: Dict, x: torch.Tensor,
                     cache: Optional[Dict] = None):
    """Returns (y, new cache {"x_ffn"})."""
    mixed, last = _mixes(x, p["ffn_mix"], cache["x_ffn"] if cache is not None
                         else None)
    k = torch.square(F.relu(mixed[0] @ p["ffn_k"]))
    r = _sigmoid(mixed[1] @ p["ffn_r"])
    return r * (k @ p["ffn_v"]), {"x_ffn": last}


def _mixes(x: torch.Tensor, mix: torch.Tensor, prev):
    """The token-shift mixes ``x + mix[i] * (xx - x)`` of every row ``i``
    of ``mix`` as one (n, B, S, d) tensor (each element rounded as the
    separate mixes round it), and the last row for the cache. One tensor
    feeds every projection, so its gradient meets in one place, whichever
    order the projections' gradients come back in."""
    xx, last = _token_shift(x, prev)
    return x + mix[:, None, None] * (xx - x), last


def rwkv6_timemix_split(ps, xs, scfg: SSMConfig, caches, split: "SH.Split"):
    """:func:`rwkv6_timemix` per mesh position (``dist.sharding.Split``):
    ``ps``, ``xs`` (B_i, S, d) and ``caches`` (each position's {state,
    x_att} of its data rank's rows, every head; ``None``: no cache) are
    per-position lists. Returns (the outputs, the new caches or ``None``).

    ``w_r``, ``w_k``, ``w_v`` and ``w_g`` are column shards and ``w_o`` a
    row shard. Where the heads divide the model axis (the reference's
    ``ssm_inner`` rule), rank j's columns are heads slice j: it runs the
    recurrence on those heads only, with their columns of the decay LoRA's
    output (its weights are replicated), ``decay_base``, ``bonus`` and
    ``ln_x``, and its gated heads times ``w_o``'s row shard are a partial
    product closed by the model sum; the new state slices are all-gathered
    before the cache write. Where they do not divide (RWKV6-3B's 40 heads
    at 16 ranks: 2.5 a rank), r, k and v are all-gathered over model and
    every rank runs every head of its rows, then closes ``w_o`` with its
    columns of the output, as ``layers.attention_split`` does for
    undivided heads."""
    groups, devs, m = split.model_groups, split.devices, split.msize
    d = xs[0].shape[-1]
    h = d // scfg.head_dim
    col = ps[0]["w_r"].shape[-1] < d
    heads = col and h % m == 0

    def cols(p, w):
        c = w["w_r"].shape[-1]
        return slice(split.rank[p] * c, (split.rank[p] + 1) * c)

    def project(p, x, w, cache):
        mixed, last = _mixes(x, w["mix"], None if cache is None
                             else cache["x_att"])
        xr, xk, xv, xg, xw = mixed.unbind(0)
        rkv = torch.stack([xr @ w["w_r"], xk @ w["w_k"], xv @ w["w_v"]])
        own = cols(p, w) if heads else slice(None)
        lora = torch.tanh(xw @ w["decay_lora_a"]) \
            @ w["decay_lora_b"][:, own]
        logw = -DECAY_CLAMP * _sigmoid(
            (w["decay_base"][own] + lora).to(torch.float32))
        return rkv, _silu(xg @ w["w_g"]), logw, last

    done = split.each(project, xs, ps, caches or [None] * split.n)
    rkv = [t[0] for t in done]
    if col and not heads:
        rkv = SH.all_gather(rkv, groups, devs, -1)

    def core(p, w, t, rkv, cache):
        _, g, logw, _ = t
        hl = h // m if heads else h
        hs = slice(split.rank[p] * hl, (split.rank[p] + 1) * hl) \
            if heads else slice(None)
        bsz, s = logw.shape[:2]
        r, k, v = (a.reshape(bsz, s, hl, scfg.head_dim) for a in rkv)
        yf, s_new = _rwkv_heads(
            r, k, v, logw.reshape(r.shape), w["bonus"][hs],
            w["ln_x"][cols(p, w) if heads else slice(None)], scfg,
            None if cache is None else cache["state"][:, hs])
        if col and not heads:             # this rank's columns of w_o
            yf = yf[..., cols(p, w)]
        return (yf.to(g.dtype) * g) @ w["w_o"], s_new

    out = split.each(core, ps, done, rkv, caches or [None] * split.n)
    outs = [o for o, _ in out]
    if col:
        outs = SH.all_reduce(outs, groups, devs)
    if caches is None:
        return outs, None
    states = [st for _, st in out]
    if heads:
        states = SH.all_gather(states, groups, devs, 1)
    return outs, [{"state": st, "x_att": t[3]}
                  for st, t in zip(states, done)]


def rwkv6_channelmix_split(ps, xs, d_ff: int, caches, split: "SH.Split"):
    """:func:`rwkv6_channelmix` per mesh position: ``ffn_k`` is a column
    shard and ``ffn_v`` a row shard, so ``k @ ffn_v`` is a partial
    product; ``ffn_r`` is a column shard, and its gate multiplies the
    closed sum. The sum is reduce-scattered, each rank gates its piece
    with its own columns of ``r`` and the gated pieces are all-gathered:
    the bytes of the all-reduce alone (all-gathering ``r`` instead adds a
    (B, S, d) gather to the all-reduce), and the gate's product runs on
    1/m of the elements; the sums are the all-reduce's, so the values are
    the same. Whole where a dim does not divide. Returns (the outputs,
    the new caches {x_ffn} or ``None``)."""
    groups, devs = split.model_groups, split.devices
    d = xs[0].shape[-1]
    k_split = ps[0]["ffn_v"].shape[0] < d_ff
    r_split = ps[0]["ffn_r"].shape[-1] < d

    def local(p, x, w, cache):
        mixed, last = _mixes(x, w["ffn_mix"], None if cache is None
                             else cache["x_ffn"])
        k = torch.square(F.relu(mixed[0] @ w["ffn_k"]))
        return k @ w["ffn_v"], _sigmoid(mixed[1] @ w["ffn_r"]), last

    done = split.each(local, xs, ps, caches or [None] * split.n)
    kv = [t[0] for t in done]
    if r_split:
        if k_split:
            kv = SH.reduce_scatter(kv, groups, devs)
        else:                             # each rank's columns of the sum
            c = d // split.msize
            kv = split.each(lambda p, a: a[..., split.rank[p] * c:
                                           (split.rank[p] + 1) * c], kv)
        outs = SH.all_gather(split.each(lambda p, a, t: t[1] * a, kv, done),
                             groups, devs, -1)
    else:
        if k_split:
            kv = SH.all_reduce(kv, groups, devs)
        outs = split.each(lambda p, a, t: t[1] * a, kv, done)
    return outs, (None if caches is None
                  else [{"x_ffn": t[2]} for t in done])
