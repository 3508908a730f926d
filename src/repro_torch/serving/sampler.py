"""Token samplers (greedy / temperature / top-k) for the serving engine,
plus the speculative-decode verify primitives (DESIGN.md §17).

Greedy is exact (first maximum, like ``jnp.argmax``). Temperature > 0
draws from an explicit ``torch.Generator``, so its tokens are not those of
the reference (another generator), only its distribution."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _mask_vocab_pad(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    if vocab_size and logits.shape[-1] > vocab_size:
        mask = torch.arange(logits.shape[-1],
                            device=logits.device) >= vocab_size
        logits = torch.where(mask, torch.full_like(logits, -1e30), logits)
    return logits


def greedy(logits: torch.Tensor, *, vocab_size: int = 0) -> torch.Tensor:
    """Argmax over the last axis with vocab-pad masking; ties go to the
    first index."""
    return torch.argmax(_mask_vocab_pad(logits, vocab_size),
                        dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, *,
           generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0,
           vocab_size: int = 0) -> torch.Tensor:
    """logits: (B, V_padded) -> (B,) int32."""
    if temperature <= 0.0:
        return greedy(logits, vocab_size=vocab_size)
    logits = _mask_vocab_pad(logits, vocab_size) / temperature
    if top_k:
        thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < thresh,
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def sample_probs(logits: torch.Tensor, *, temperature: float,
                 top_k: int = 0, vocab_size: int = 0) -> torch.Tensor:
    """The categorical distribution :func:`sample` draws from at
    ``temperature > 0`` (same masking and scaling, an f32 simplex over the
    last axis). The rejection-sampled verify needs the explicit draft (q)
    and target (p) probabilities, not just a draw."""
    if temperature <= 0.0:
        raise ValueError("sample_probs is the temperature>0 distribution; "
                         "greedy verify compares argmax targets instead")
    logits = _mask_vocab_pad(logits, vocab_size) / temperature
    if top_k:
        thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < thresh,
                             torch.full_like(logits, -1e30), logits)
    return torch.softmax(logits.to(torch.float32), dim=-1)


def speculative_verify(draft_tokens: np.ndarray, q_probs: np.ndarray,
                       p_probs: np.ndarray, accept_uniforms: np.ndarray,
                       residual_uniforms: np.ndarray
                       ) -> Tuple[int, int]:
    """Chain rejection sampling for one slot (Leviathan et al.); numpy on
    the host, a copy of the reference's.

    draft_tokens: (k,) tokens proposed by the draft model;
    q_probs: (k, V) draft distribution each was drawn from;
    p_probs: (k+1, V) target distributions from the verify forward
    (row j conditions on the prefix through draft j);
    accept_uniforms / residual_uniforms: (k,) / (k+1,) U(0,1) draws.

    Returns ``(accepted, final_token)``: draft j is accepted with
    probability ``min(1, p[d_j]/q[d_j])``; the first rejection resamples
    from the normalized residual ``max(p - q, 0)``; full acceptance draws
    the bonus token from ``p[k]``. The emitted stream
    ``draft_tokens[:accepted] + [final_token]`` is distributed exactly as
    k+1 sequential target samples."""
    k = len(draft_tokens)
    for j in range(k):
        d = int(draft_tokens[j])
        p_d = float(p_probs[j, d])
        q_d = float(q_probs[j, d])
        if q_d <= 0.0 or accept_uniforms[j] * q_d > p_d:
            residual = np.maximum(
                p_probs[j].astype(np.float64)
                - q_probs[j].astype(np.float64), 0.0)
            z = residual.sum()
            if z <= 0.0:        # p == q: any p-sample is exact
                residual, z = p_probs[j].astype(np.float64), \
                    float(p_probs[j].sum())
            cdf = np.cumsum(residual / z)
            tok = int(np.searchsorted(cdf, float(residual_uniforms[j]),
                                      side="right"))
            return j, min(tok, len(cdf) - 1)
    p_last = p_probs[k].astype(np.float64)
    cdf = np.cumsum(p_last / p_last.sum())
    tok = int(np.searchsorted(cdf, float(residual_uniforms[k]),
                              side="right"))
    return k, min(tok, len(cdf) - 1)
