"""Token sampling: greedy, temperature, top-k and top-p, with seeded noise
that reproduces the JAX package's bits; the presence, frequency and
repetition penalties (:func:`apply_penalties`, bit-identical to the JAX
package's); the guided-decoding allow-mask (:func:`apply_allow`).

Per-request parameters are [B] vectors, so one call serves any mix of greedy
and sampled rows. As in the JAX package, top-k and top-p work on a static
candidate set of the ``MAX_TOPK`` best logits, and ``temperature <= 0``
selects the argmax.

Random draws follow the JAX package's seeded path (``ops/sampling.py``):
row b's key is ``fold_in(key(seed_b), ctr_b)`` (:func:`per_slot_keys`), and
candidate token t's Gumbel noise is ``uniform(fold_in(row_key, t))``, so a
draw is a pure function of (seed, position, token id) and not of the batch
around it. The keys are jax.random's default: threefry2x32 with
``jax_threefry_partitionable`` on (the default since JAX 0.5). torch has no
unsigned 32-bit shifts, so the words are held in int64 tensors and masked to
32 bits after every operation that can carry past them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

MAX_TOPK = 64

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0, x1):
    """The threefry-2x32 block function (20 rounds), as jax.random computes
    it. Every argument is an int64 tensor (or int) of uint32 values, all
    broadcastable; returns the two output words (int64, uint32 values)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) & _MASK32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def random_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.key(seed)`` for uint32 seeds: [..., 2] int64 words
    (0, seed)."""
    seed = seed.long() & _MASK32
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2], data [...] (read as uint32)
    -> [..., 2]. The key of data d is threefry(key, (0, d))."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data.long() & _MASK32)
    return torch.stack([y0, y1], dim=-1)


def uniform(key: torch.Tensor, minval: float = 1e-20) -> torch.Tensor:
    """``jax.random.uniform(key, (), float32, minval)`` for every key of
    [..., 2]: the top 23 bits of threefry(key, (0, 0)) as a float in
    [1, 2), minus 1, then shifted to [minval, 1). The bounds are float32
    values computed on the host (a float32 tensor takes a Python scalar as
    float32), so nothing is uploaded and the call can be captured in a
    CUDA graph."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, 0)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000           # below 2**31: fits int32
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    width = float(np.float32(1.0) - lo)
    lo = float(lo)
    return (floats * width + lo).clamp_min(lo)


def per_slot_keys(seeds: torch.Tensor, ctrs: torch.Tensor) -> torch.Tensor:
    """[B, 2] keys ``fold_in(key(seed_b), ctr_b)`` (the JAX package's
    ``ops/sampling.per_slot_keys``): each draw is a function of the
    request's seed and its token position only. seeds [B] (uint32 values in
    int64); ctrs [B]."""
    return fold_in(random_key(seeds), ctrs)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    presence: torch.Tensor, frequency: torch.Tensor,
                    repetition: Optional[torch.Tensor] = None,
                    prompt_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The OpenAI presence and frequency penalties and the vLLM/HF
    ``repetition_penalty``, in float32 (the JAX package's
    ``ops/sampling.apply_penalties``).

    logits [B, V]; counts [B, V] int (each token's count in the slot's
    generated text); presence, frequency [B], subtracted from the raw
    logits (``frequency * count + presence * (count > 0)``; zero is an
    exact no-op). ``repetition`` [B] (1.0: off) first scales every token
    seen in the prompt (``prompt_mask`` [B, V] bool) or generated so far:
    a positive logit is divided by it, any other multiplied.
    """
    c = counts.float()
    out = logits.float()
    if repetition is not None:
        seen = c > 0
        if prompt_mask is not None:
            seen = seen | prompt_mask
        r = repetition.float()[:, None]
        out = torch.where(seen, torch.where(out > 0, out / r, out * r), out)
    return out - frequency.float()[:, None] * c \
        - presence.float()[:, None] * (c > 0).float()


def allow_banned(allow: torch.Tensor, V: int) -> torch.Tensor:
    """The tokens a guided-decoding allow-bitmask rejects, [B, V] bool:
    token v is allowed iff bit (v & 31) of word ``allow[b, v >> 5]`` is
    set. ``allow`` [B, ceil(V/32)] holds the grammar's uint32 words as
    int32 with the same bits (torch has little uint32 arithmetic, on CUDA
    least of all). The words are read as their little-endian bytes
    (uint8: no sign to extend; bit j of byte i is token 8 i + j of the
    word), so the unpacked bits take a quarter of an int32 unpacking's
    memory. A dispatch unpacks its words once for all its substeps."""
    B, W = allow.shape
    octets = allow.contiguous().view(torch.uint8)               # [B, 4 W]
    shifts = torch.arange(8, dtype=torch.uint8, device=allow.device)
    bits = (octets[:, :, None] >> shifts) & 1                    # [B, 4W, 8]
    return (bits == 0).reshape(B, W * 32)[:, :V]


def apply_allow(logits: torch.Tensor, allow: torch.Tensor,
                banned: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``apply_allow``: logits [B, V] with every token
    that the allow words [B, ceil(V/32)] reject set to -inf (an all-ones
    row is an exact no-op), in one select. ``banned`` (:func:`allow_banned`
    of ``allow``, unpacked once) skips the unpacking."""
    if banned is None:
        banned = allow_banned(allow, logits.shape[-1])
    return torch.where(banned, float("-inf"), logits)


def sample(logits: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor,
           seeds: Optional[torch.Tensor] = None,
           ctrs: Optional[torch.Tensor] = None,
           any_sampled: Optional[bool] = None) -> torch.Tensor:
    """Sampled token ids [B] (int32) from logits [B, V].

    temperature [B] (<= 0: greedy); top_k [B] (<= 0: all ``MAX_TOPK``
    candidates); top_p [B] (1.0: off). Row b's key is
    ``per_slot_keys(seeds, ctrs)[b]``, derived only when some row samples
    (a greedy batch does no random work and may pass no seeds).
    ``any_sampled``: whether some row has temperature > 0, as the caller
    knows it from its host mirrors; None reads it from ``temperature``, a
    device-to-host read that a decode substep must not make. With True the
    sampled path runs and greedy rows still take the argmax.
    """
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if any_sampled is None:
        any_sampled = bool((temperature > 0).any())
    if not any_sampled:
        return greedy
    if seeds is None or ctrs is None:
        raise ValueError("sample: sampled rows need seeds and ctrs")
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
    # token-id-keyed Gumbel: candidate t's noise depends on t, not on its
    # rank, so masking one token never moves another token's draw
    keys = per_slot_keys(seeds, ctrs)
    u = uniform(fold_in(keys[:, None, :], idxs))
    draw = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    sampled = torch.gather(idxs, 1, draw[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature <= 0, greedy, sampled)
