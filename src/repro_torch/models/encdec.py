"""Encoder-decoder stack (SeamlessM4T backbone), as in
``repro.models.encdec``.

The speech frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_src, d) in the model's dtype. The decoder is the shared
``decoder_forward`` with cross-attention; at prefill the encoder output
is computed once and carried in the cache. Cross K/V are recomputed on
every call (the reference's choice: cheap beside self-attention; caching
them is a recorded optimization).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_maybe_remat, decoder_forward,
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
