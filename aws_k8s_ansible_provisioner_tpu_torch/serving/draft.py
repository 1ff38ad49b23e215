"""Draft-model speculative decoding: a small LM proposes, the target verifies.

A copy of the JAX package's ``serving/draft.py`` for the port's engine. The
draft runs the engine's own step programs over a dense slot cache of its
own (``kv_cache.init_cache``, never quantized): ``decode_steps`` (greedy,
horizon spec_k, kernels K8 and K4) for the rollout and ``spec_decode_step``
(R = spec_k + 1 rows, argmax side only, kernels K8 and K7) to teacher-force
the tokens a plain dispatch emitted while the draft stood still. The
programs take the draft's own ``cfg.sliding_window``, so a windowed draft
attends its dense cache through the kernels' window instances.

Cache coherence (the engine's ``lengths[slot]`` counts the target cache's
rows; the newest emitted token, ``last_token``, is not among them and is
written at row ``lengths`` by the next dispatch):

- ``lens[slot]`` counts rows of the draft cache holding TRUE context K/V,
  the next write position. The steady state is ``lens == engine.lengths``:
  the newest emitted token's K/V rides the next draft dispatch, as it does
  in the target's own cache, and at its own position.
- A proposal dispatch feeds the newest emitted token at position ``lens``
  and greedily rolls K tokens, writing K rows (the token and the first
  K - 1 drafts). The accepted prefix of those rows is already correct
  context (greedy draft rows are the drafts' own K/V), so after the verify
  emits m drafts + 1 correction the sync is just ``lens += min(m + 1, K)``,
  with no rollback copies; a fully accepted round leaves the K-th draft
  for the next catch-up.
- Rejected-draft rows and catch-up padding rows are garbage BEYOND
  ``lens``; every position is rewritten when its true token is processed,
  before any query can attend it.
- Slots the draft cannot cheaply track (chunked prefills, preemption
  resumes) turn ``stale`` and stop proposing: per-slot degradation, never
  engine-wide.

The JAX package's draft keeps ``engine.lengths - lens == 1`` instead, one
row short of the target and every later row one position early (ROADMAP
C7); its proposals are worse, its streams the same, since the verify
decides every emitted token. The engine caps plain-path horizons at
spec_k + 1 while a draft is attached, so the catch-up gap of one plain
dispatch fits one R-wide dispatch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.models.layers import DecoderLM
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc
from aws_k8s_ansible_provisioner_tpu_torch.serving.programs import (
    decode_steps, prefill_batch_step, spec_decode_step)


class DraftModel:
    """The draft network, its per-slot dense KV cache and the sync state."""

    def __init__(self, cfg: ModelConfig, params: dict, num_slots: int,
                 max_len: int, device: torch.device):
        self.cfg = cfg
        self.model = DecoderLM(cfg, params).to(device)
        self.device = device
        # the cache holds K/V in the draft's own compute type, which its
        # kernels take
        self.cache = kvc.init_cache(cfg, num_slots, max_len,
                                    self.model.compute_dtype, device)
        self.num_slots = num_slots
        self.max_len = max_len
        # rows of TRUE context K/V per slot (== next write position)
        self.lens = np.zeros(num_slots, np.int32)
        # rows the last rollout wrote per slot (its K)
        self.rolled = 0
        # chunked/resumed slots: the cache cannot be cheaply rebuilt
        self.stale = np.zeros(num_slots, bool)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _greedy(self, n: int):
        """Sampling operands of an all-greedy batch of n rows."""
        return (torch.zeros(n, device=self.device),
                torch.zeros(n, dtype=torch.int32, device=self.device),
                torch.ones(n, device=self.device),
                torch.zeros(n, dtype=torch.int64, device=self.device))

    # -- admission sync -----------------------------------------------------

    def prefill(self, tokens: np.ndarray, true_lens: np.ndarray,
                slots: np.ndarray) -> None:
        """Mirror a batched target prefill into the draft cache (one extra
        dispatch per admission batch). Its sampled tokens are discarded;
        only the K/V writes matter."""
        n = tokens.shape[0]
        self.cache, _ = prefill_batch_step(
            self.model, self.cache, self._dev(tokens), self._dev(true_lens),
            None, *self._greedy(n), slots=self._dev(slots))
        for i in range(n):
            s = int(slots[i])
            self.lens[s] = int(true_lens[i])
            self.stale[s] = False

    def mark_stale(self, slot: int) -> None:
        self.stale[slot] = True

    # -- per-round proposal -------------------------------------------------

    def propose(self, engine, eligible: List[int],
                K: int) -> Optional[Tuple[np.ndarray, dict]]:
        """Return (drafts [num_slots, K], {slot: K}) or None.

        1. catch-up: slots behind the target (a plain or mixed dispatch
           advanced them) teacher-force the missed tokens through the draft,
           R per slot in each R-wide dispatch, until none is behind (one
           dispatch after a plain one; the JAX draft makes one per round,
           and a slot more than R + 1 rows behind then falls back R rows
           with every plain dispatch that the round without drafts takes);
        2. rollout: one fused greedy ``decode_steps`` over the whole slot
           axis proposes K tokens for every up-to-date slot.
        """
        R = K + 1
        gaps = {s: int(engine.lengths[s]) - int(self.lens[s])
                for s in eligible if not self.stale[s]}
        while True:
            behind = [s for s, g in gaps.items() if 0 < g <= self.max_len]
            if not behind or not self._catch_up(engine, behind, R):
                break
            gaps = {s: int(engine.lengths[s]) - int(self.lens[s])
                    for s in gaps}
        ready = [s for s, g in gaps.items()
                 if g == 0 and int(self.lens[s]) + K < self.max_len]
        if not ready:
            return None
        self.rolled = K
        self.cache, out = decode_steps(
            self.model, K, self.cache, self._dev(engine.last_token),
            self._dev(self.lens), None, *self._greedy(self.num_slots),
            any_sampled=False)
        out = out.cpu().numpy()                                   # [K, B]
        drafts = np.zeros((self.num_slots, K), np.int32)
        proposed = {}
        for s in ready:
            drafts[s] = out[:, s]
            proposed[s] = K
        # non-ready rows wrote garbage K/V at THEIR lens..lens+K-1: future
        # positions, rewritten before any query attends them; their lens
        # stays put, so nothing is lost
        return drafts, proposed

    def _catch_up(self, engine, slots: List[int], R: int) -> bool:
        """Teacher-force up to R tokens of target-emitted context the draft
        missed, through the verify program's multi-row K/V writes (its
        argmax output is discarded). Returns whether any slot advanced."""
        tokens = np.zeros((self.num_slots, R), np.int32)
        adv = np.zeros(self.num_slots, np.int32)
        for s in slots:
            req = engine.slot_req[s]
            if req is None:
                continue
            ctx = req.prompt_ids + req.generated
            # the rows the target holds; the newest token (ctx[lengths])
            # is left for the proposal dispatch
            cu = ctx[int(self.lens[s]):int(engine.lengths[s])][:R]
            if not cu:
                continue
            tokens[s, :len(cu)] = cu
            tokens[s, len(cu):] = cu[-1]                  # pad: surplus rows
            adv[s] = len(cu)
        if not adv.any():
            return False
        self.cache, _, _ = spec_decode_step(
            self.model, R, self.cache, self._dev(tokens),
            self._dev(self.lens), None, *self._greedy(self.num_slots))
        self.lens += adv
        return True

    # -- post-verify sync ---------------------------------------------------

    def note_emitted(self, slot: int, n: int) -> None:
        """After a verify emitted ``n`` tokens for a drafted slot: the first
        n of this round's rollout rows (newest token + accepted drafts) are
        now true context, as far as the rollout wrote rows."""
        self.lens[slot] = min(self.lens[slot] + min(n, self.rolled),
                              self.max_len)
