"""Shared neural layers (plain functions over parameter dicts).

Conventions (as in ``repro.models.layers``):
  * params are nested dicts keyed by the names in ModelConfig.param_shapes()
  * activations are bf16, reductions/norms/softmax in f32
  * attention supports GQA (kv < heads), sliding-window ring-buffer KV
    caches whose entries carry absolute-position tags (-1 = empty), so
    sliding-window masks stay exact after the ring wraps, causal and
    bidirectional self-attention, and cross-attention

Attention has the reference's cached branches (prefill-from-empty and
decode over the ring buffer). Grouped-query attention contracts without
expanding K/V, as the reference does on one device; under an active mesh
whose model axis divides the heads, full attention takes the reference's
flat spelling (K/V repeated per head), which ``dist.sharding.
full_grouped_ok`` chooses. Decode always groups.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig
from repro_torch.dist.sharding import full_grouped_ok


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
            ).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (.., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# KV cache: fixed-size ring buffer (window = sliding_window or max length),
# slots tagged with absolute positions (-1 = empty).
# --------------------------------------------------------------------------

def _update_cache(cache, k_new, v_new, positions):
    """Insert S_new entries at slots ``position % window``. Writes IN PLACE
    into the cache tensors (the engine holds the only reference, and the
    multi-layer cache is never copied per token); returns the same dict."""
    window = cache["k"].shape[1]
    slots = positions % window                                 # (B, S_new)
    b_idx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    cache["k"][b_idx, slots] = k_new.to(cache["k"].dtype)
    cache["v"][b_idx, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][b_idx, slots] = positions.to(cache["pos"].dtype)
    return cache


def _spec_update_cache(cache, k_new, v_new, positions):
    """Ring-buffer insert that DROPS rows tagged position < 0.

    The speculative paths (draft + batched verify, DESIGN.md §17) carry
    right-padded draft tails and idle decode slots as position -1; the
    plain modulo write would alias them onto slot ``window - 1`` and
    clobber a live entry. The reference drops them with a scatter
    ``mode="drop"``, which torch lacks, and a boolean index would sync
    the host; instead every ring slot takes the new row that targets it,
    if a live one does, and keeps its entry otherwise (live rows of one
    slot never share a ring index: the engine's depth clamp keeps a
    speculative span inside the window). Writes IN PLACE."""
    window = cache["k"].shape[1]
    live = positions >= 0                                      # (B, S)
    ring = torch.arange(window, device=positions.device)
    hit = live[:, :, None] & (positions[:, :, None] % window == ring)
    written = hit.any(dim=1)                                   # (B, W)
    src = hit.to(torch.int64).argmax(dim=1)                    # (B, W)

    def put(dst, new):
        idx = src.reshape(src.shape + (1,) * (new.ndim - 2))
        taken = torch.gather(new.to(dst.dtype), 1,
                             idx.expand((-1, -1) + tuple(new.shape[2:])))
        mask = written.reshape(written.shape + (1,) * (new.ndim - 2))
        dst.copy_(torch.where(mask, taken, dst))

    put(cache["k"], k_new)
    put(cache["v"], v_new)
    put(cache["pos"], positions)
    return cache


def _prefill_cache(cache, k_new, v_new, positions):
    """Prefill-from-empty cache contents: positions are contiguous
    0..S-1, so the ring buffer is a (rolled) slice of k/v."""
    b, s, hkv, hd = k_new.shape
    window = cache["k"].shape[1]
    if s >= window:
        shift = (s - window) % window      # slot of the first kept entry
        def cut(a):
            return torch.roll(a[:, -window:], shift, dims=1)
        k, v, pos = cut(k_new), cut(v_new), cut(positions)
    else:
        k = F.pad(k_new, (0, 0, 0, 0, 0, window - s))
        v = F.pad(v_new, (0, 0, 0, 0, 0, window - s))
        pos = F.pad(positions, (0, window - s), value=-1)
    return {"k": k.to(cache["k"].dtype),
            "v": v.to(cache["v"].dtype),
            "pos": pos.to(torch.int32)}


_Q_CHUNK = 512      # query-block size for long-sequence attention


def _sdpa_grouped_block(q, k, v, mask, scale) -> torch.Tensor:
    """GQA without materializing repeated K/V: queries are reshaped to
    (B, Sq, Hkv, G, hd) and contract the SHARED kv head dim directly."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q5 = q.reshape(b, sq, hkv, g, hd)
    logits = torch.einsum("bqcgd,bkcd->bcgqk", q5.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = torch.where(mask[:, :, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    # probs rounded to the model dtype as in the reference, then its
    # f32-accumulated product with v, rounded once
    out = torch.einsum("bcgqk,bkcd->bqcgd", probs.to(torch.float32),
                       v.to(torch.float32)).to(q.dtype)
    return out.reshape(b, sq, h, hd)


def _sdpa_block(q, k, v, mask, scale) -> torch.Tensor:
    """The flat contraction over (B, H, Sq, Sk) scores: K/V have a head
    per query head."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)


def _full_grouped(h: int, hkv: int) -> bool:
    """Full attention's spelling: the reference's ``full_grouped_ok``,
    except that multi-head attention (hkv == h) keeps the grouped
    spelling, the same contraction with groups of one."""
    return hkv == h or full_grouped_ok(h, hkv)


def _sdpa(q, k, v, mask, grouped: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,hd) k,v: (B,Sk,Hkv,hd) mask: (B,1,Sq,Sk) bool.

    ``grouped=False`` repeats K/V per query head and contracts flat.
    Long queries are processed in blocks of _Q_CHUNK so the score tensor is
    O(chunk x Sk), never O(Sq x Sk); exact softmax (each block sees all
    of K)."""
    sq, h, hd = q.shape[1], q.shape[2], q.shape[3]
    if not grouped:
        rep = h // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    block = _sdpa_grouped_block if grouped else _sdpa_block
    scale = hd ** -0.5
    if sq <= 2 * _Q_CHUNK or sq % _Q_CHUNK:
        return block(q, k, v, mask, scale)
    outs = [block(q[:, i:i + _Q_CHUNK], k, v, mask[:, :, i:i + _Q_CHUNK],
                  scale)
            for i in range(0, sq, _Q_CHUNK)]
    return torch.cat(outs, dim=1)


def attention(p: Dict[str, Any], x: torch.Tensor, acfg: AttentionConfig, *,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]],
              kv_x: Optional[torch.Tensor] = None,
              spec: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention, through a ring-buffer KV cache or none.

    x: (B, S, d); positions: (B, S) absolute positions of x (-1 = pad).
    kv_x (B, S_src, d) -> cross-attention: K and V from ``kv_x``, no rope
    on q or k (qk-norm still applies), every source position attended, no
    cache written.
    cache=None -> full attention over x with the causal/SWA mask (or none
    where ``acfg.causal`` is false: the encoder), no cache (the no-cache
    forward of ``Model.loss_fn``); returns ``None`` as the new cache.
    S > 1 -> prefill-from-empty: attend over the in-context k/v and return
    the freshly written ring buffer.
    S == 1 -> decode: the new k/v go into the ring buffer (in place) and
    attention runs over it with position-tag masking.
    spec -> speculative multi-token decode (DESIGN.md §17): S >= 1 new
    tokens extend the LIVE cache in place (never the prefill rewrite), and
    rows tagged position -1 are dropped instead of aliased by the modulo.
    """
    b, s, d = x.shape
    h, hkv, hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    src = kv_x if kv_x is not None else x

    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (src @ p["wk"]).reshape(b, src.shape[1], hkv, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], hkv, hd)

    if acfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])

    cross = kv_x is not None
    if not cross:
        q = rope(q, positions, acfg.rope_theta)
        k = rope(k, positions, acfg.rope_theta)
    g_full = _full_grouped(h, hkv)

    if cross:
        new_cache = None
        mask = torch.ones((b, 1, s, src.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, k, v, mask, g_full)
    elif cache is None:
        new_cache = None
        qpos = positions
        mask = qpos[:, None, :, None] >= qpos[:, None, None, :] \
            if acfg.causal else torch.ones((b, 1, s, s), dtype=torch.bool,
                                           device=x.device)
        if acfg.causal and acfg.sliding_window:
            mask &= (qpos[:, None, :, None] - qpos[:, None, None, :]
                     < acfg.sliding_window)
        out = _sdpa(q, k, v, mask, g_full)
    elif s > 1 and not spec:
        new_cache = _prefill_cache(cache, k, v, positions)
        qpos = positions
        # right-padded slot prefills tag pads with pos=-1; never attended
        mask = (qpos[:, None, :, None] >= qpos[:, None, None, :]) \
            & (qpos[:, None, None, :] >= 0)
        if acfg.sliding_window:
            mask &= (qpos[:, None, :, None] - qpos[:, None, None, :]
                     < acfg.sliding_window)
        out = _sdpa(q, k, v, mask, g_full)
    else:
        # decode (S == 1) or speculative draft/verify (spec, S >= 1): the
        # position-tag mask below is exact for S > 1 queries too
        writer = _spec_update_cache if spec else _update_cache
        new_cache = writer(cache, k, v, positions)
        kpos = new_cache["pos"]                                  # (B, W)
        qpos = positions                                         # (B, S)
        valid = kpos[:, None, None, :] >= 0
        causal = kpos[:, None, None, :] <= qpos[:, None, :, None]
        mask = valid & causal
        if acfg.sliding_window:
            mask &= (qpos[:, None, :, None] - kpos[:, None, None, :]
                     < acfg.sliding_window)
        out = _sdpa(q, new_cache["k"], new_cache["v"], mask)

    return out.reshape(b, s, h * hd) @ p["wo"], new_cache


def mlp(p: Dict[str, Any], x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if act == "gelu":
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    if act == "relu_sq":
        return torch.square(F.relu(x @ p["w_up"])) @ p["w_down"]
    raise ValueError(act)


class _Embed(torch.autograd.Function):
    """``table[ids]`` whose backward sums the rows of repeated ids as a
    product with the one-hot matrix of ``ids`` (in cuBLAS's fixed order),
    not as an index backward's scatter-add, whose order of adds PyTorch
    does not fix: two identical train steps give the same bits."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        grad = grad.reshape(-1, grad.shape[-1])
        flat = ids.reshape(-1)
        onehot = (flat[:, None] == torch.arange(
            ctx.rows, device=flat.device)).to(grad.dtype)
        return onehot.t() @ grad, None


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return _Embed.apply(table, ids)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (V,d)^T -> (B,S,V) logits in f32 (f32 products and sums,
    like the reference's ``preferred_element_type=f32``)."""
    return torch.einsum("bsd,vd->bsv", x.to(torch.float32),
                        table.to(torch.float32))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean NLL with padded-vocab masking (positions with label < 0 are
    ignored), in f32."""
    v_pad = logits.shape[-1]
    logits = logits.to(torch.float32)
    if v_pad > vocab_size:
        pad = torch.arange(v_pad, device=logits.device) >= vocab_size
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.long)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1)
