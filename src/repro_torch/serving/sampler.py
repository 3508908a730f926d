"""Token samplers (greedy / temperature / top-k) for the serving engine.

Greedy is exact (first maximum, like ``jnp.argmax``). Temperature > 0
draws from an explicit ``torch.Generator``, so its tokens are not those of
the reference (another generator), only its distribution."""
from __future__ import annotations

from typing import Optional

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
