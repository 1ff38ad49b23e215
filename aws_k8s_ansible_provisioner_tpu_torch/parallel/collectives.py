"""The collectives of the single-controller mesh.

GSPMD emits these implicitly in the JAX package: a row-parallel matmul's
partial sums are ``psum``'d over ``tp``, vocab-sharded logits are gathered
where a full-vocabulary op reads them, and a vocab-sharded embedding lookup
is a masked gather plus a ``psum``. The port's mesh is one process driving
every shard (``parallel/mesh.py``), so a collective is explicit copies in
a fixed order: no ``torch.distributed`` and no NCCL. With every shard on
one device the copies are no-ops and a collective is plain arithmetic;
with shards on distinct cards the copies go card to card. Nothing is ever
placed on the CPU unless the shards are there.

The order and dtype of a sum (:func:`all_reduce`): the partials, each
already rounded to the activation dtype (a shard's matmul output), are
added in shard order on the first shard's device, one rounding to that
dtype per add, ``((p0 + p1) + p2) + p3``; the JAX tp forward on the CPU
rounds the same way (a partial in the activation dtype, then added).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def all_reduce(parts: Sequence[torch.Tensor], devices: Sequence
               ) -> List[torch.Tensor]:
    """The sum of per-shard partials, in shard order, on the first
    device, handed back on every device of ``devices`` (the same tensor
    where a device repeats)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return broadcast(total, devices)


def broadcast(x: torch.Tensor, devices: Sequence) -> List[torch.Tensor]:
    """``x`` on every device of ``devices``, one copy per distinct device
    (``x`` itself on its own)."""
    made = {str(x.device): x}
    out = []
    for dev in devices:
        key = str(torch.device(dev))
        if key not in made:
            made[key] = x.to(dev)
        out.append(made[key])
    return out


def all_gather(parts: Sequence[torch.Tensor], device, dim: int = -1
               ) -> torch.Tensor:
    """The shards' slices concatenated along ``dim`` in shard order (the
    vocabulary order of vocab-sharded logits) on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def vocab_embed(tables: Sequence[dict], tokens: Sequence[torch.Tensor],
                dtype: torch.dtype) -> List[torch.Tensor]:
    """The vocab-sharded embedding lookup, one part a shard: shard t holds
    the rows ``[t * V_t, (t + 1) * V_t)`` of the table (``{"weight"}``,
    with ``{"scale"}`` per row when int8) and gathers the ids of
    ``tokens[t]`` (the token ids on its device) that fall in its range,
    zeros elsewhere; an int8 row is dequantized with its scale and rounded
    to ``dtype``. Summed with :func:`all_reduce` this is the whole
    table's lookup exactly (one shard's part is nonzero per token)."""
    out = []
    for t, (emb, tok) in enumerate(zip(tables, tokens)):
        n = emb["weight"].shape[0]
        local = tok.long() - t * n
        valid = (local >= 0) & (local < n)
        idx = torch.where(valid, local, torch.zeros_like(local))
        if "scale" in emb:
            rows = (emb["weight"][idx].float()
                    * emb["scale"][idx][..., None]).to(dtype)
        else:
            rows = emb["weight"][idx]
        out.append(torch.where(valid[..., None], rows,
                               torch.zeros_like(rows)))
    return out
