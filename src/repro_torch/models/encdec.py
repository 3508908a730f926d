"""Encoder-decoder stack (SeamlessM4T backbone), as in
``repro.models.encdec``.

The speech frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_src, d) in the model's dtype. The decoder is the shared
``decoder_forward`` with cross-attention; at prefill the encoder output
is computed once and carried in the cache. Cross K/V are recomputed on
every call (the reference's choice: cheap beside self-attention; caching
them is a recorded optimization). The ``*_split`` forms run the same
stacks over a (data, model) mesh (``dist.sharding.Split``), ``src`` and
``enc_out`` split over the data ranks like the tokens.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_add_split, _maybe_remat,
                                            _norm_split, decoder_forward,
                                            decoder_forward_split,
                                            layer_slice)


def encoder_forward(params, cfg: ModelConfig, src: torch.Tensor):
    """src: (B, S_src, d) frontend embeddings -> (B, S_src, d): the
    bidirectional (non-causal, cache-free) encoder stack, then
    ``encoder_norm``."""
    positions = torch.arange(src.shape[1], device=src.device)[None].expand(
        src.shape[:2])
    acfg = dataclasses.replace(cfg.attention, causal=False)

    def block(x, p):
        h, _ = L.attention(p["attn"],
                           L.rms_norm(x, p["attn_norm"]["scale"]),
                           acfg, positions=positions, cache=None)
        x = x + h
        h = L.mlp(p["mlp"], L.rms_norm(x, p["ffn_norm"]["scale"]), cfg.act)
        return x + h

    body = _maybe_remat(block, cfg)
    x = src
    for li in range(cfg.num_encoder_layers):
        x = body(x, layer_slice(params["encoder"], li))
    return L.rms_norm(x, params["encoder_norm"]["scale"])


def encdec_forward(params, cfg: ModelConfig, x, positions, *,
                   caches=None, enc_out=None, src=None, **kw):
    """Decoder over embedded targets ``x`` with cross-attention to
    ``enc_out`` (or freshly encoded ``src``). caches: {"self": the
    decoder's ring KV cache, "enc_out": (B, S_src, d)}."""
    if enc_out is None:
        if src is None:
            raise ValueError("enc-dec needs src embeddings or enc_out")
        enc_out = encoder_forward(params, cfg, src)
    dec_caches = None if caches is None else caches["self"]
    y, new_self, aux = decoder_forward(
        params, cfg, x, positions, caches=dec_caches, enc_out=enc_out, **kw)
    new_caches = None
    if caches is not None:
        new_caches = {"self": new_self, "enc_out": enc_out}
    return y, new_caches, aux


def encoder_forward_split(pos_params, cfg: ModelConfig, srcs, split):
    """:func:`encoder_forward` over a (data, model) mesh: ``srcs`` are
    each position's data-rank rows of ``src``; every layer runs
    ``layers.attention_split`` (non-causal, no cache) and ``mlp_split``
    on each position's shards. Returns each position's rows of
    ``enc_out``."""
    poss = split.each(lambda p, s: torch.arange(
        s.shape[1], device=s.device)[None].expand(s.shape[:2]), srcs)
    acfg = dataclasses.replace(cfg.attention, causal=False)
    tables = L.position_tables(acfg, poss, split, False)

    def block(xs, ps):
        hs, _ = L.attention_split(
            [p["attn"] for p in ps], _norm_split(xs, ps, "attn_norm", split),
            acfg, poss=poss, caches=None, split=split, tables=tables)
        xs = _add_split(xs, hs, split)
        hs = L.mlp_split([p["mlp"] for p in ps],
                         _norm_split(xs, ps, "ffn_norm", split), cfg.act,
                         cfg.d_ff, split)
        return _add_split(xs, hs, split)

    body = _maybe_remat(block, cfg)
    xs = srcs
    for li in range(cfg.num_encoder_layers):
        xs = body(xs, [layer_slice(t["encoder"], li) for t in pos_params])
    return _norm_split(xs, pos_params, "encoder_norm", split)


def encdec_forward_split(pos_params, cfg: ModelConfig, xs, poss, *,
                         caches, split, enc_outs=None, srcs=None, **kw):
    """:func:`encdec_forward` over a (data, model) mesh: per-position
    lists of params, targets, positions, caches ({"self": the decoder's
    ring stacks, "enc_out": the data rank's rows}) and ``enc_outs`` or
    ``srcs`` (encoded here). Returns (ys, the new caches, aux)."""
    if enc_outs is None:
        if srcs is None:
            raise ValueError("enc-dec needs src embeddings or enc_out")
        enc_outs = encoder_forward_split(pos_params, cfg, srcs, split)
    ys, new_self, aux = decoder_forward_split(
        pos_params, cfg, xs, poss,
        caches=None if caches is None else [c["self"] for c in caches],
        split=split, enc_outs=enc_outs, **kw)
    new = None if caches is None else \
        [{"self": n, "enc_out": e} for n, e in zip(new_self, enc_outs)]
    return ys, new, aux
