"""Token sampling: greedy, temperature, top-k and top-p.

Per-request parameters are [B] vectors, so one call serves any mix of greedy
and sampled rows. As in the JAX package, top-k and top-p work on a static
candidate set of the ``MAX_TOPK`` best logits, and ``temperature <= 0``
selects the argmax. Random draws come from the caller's ``torch.Generator``
(Gumbel-max over the candidates); they cannot reproduce the JAX package's
threefry bits, so only greedy streams are comparable across the two.
"""

from __future__ import annotations

from typing import Optional

import torch

MAX_TOPK = 64


def sample(logits: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sampled token ids [B] (int32) from logits [B, V].

    temperature [B] (<= 0: greedy); top_k [B] (<= 0: all ``MAX_TOPK``
    candidates); top_p [B] (1.0: off). ``generator`` must live on the
    logits' device; it is only drawn from when some row samples.
    """
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not bool((temperature > 0).any()):
        return greedy
    B, V = logits.shape
    cap = min(MAX_TOPK, V)
    vals, idxs = torch.topk(logits, cap, dim=-1)                 # descending
    ranks = torch.arange(cap, device=logits.device)[None, :]
    eff_k = torch.where(top_k <= 0, torch.full_like(top_k, cap),
                        top_k.clamp(max=cap))
    neg = torch.full_like(vals, float("-inf"))
    vals = torch.where(ranks < eff_k[:, None], vals, neg)
    safe_t = temperature.float().clamp(min=1e-6)[:, None]
    probs = torch.softmax(vals / safe_t, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p.float()[:, None]   # mass before me < top_p
    keep[:, 0] = True
    scaled = torch.where(keep, vals, neg) / safe_t
    u = torch.rand(scaled.shape, generator=generator, device=logits.device)
    u = u.clamp(min=1e-20)
    draw = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    sampled = torch.gather(idxs, 1, draw[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature <= 0, greedy, sampled)
