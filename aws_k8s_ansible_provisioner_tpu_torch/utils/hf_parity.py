"""Checkpoint validation: the port's greedy generations against
HuggingFace's, token for token.

The port's copy of the JAX package's ``utils/hf_parity.py``: a checkpoint
directory is loaded through the serving path (``serving/server.build_state``
with ``checkpoint_dir``: ``config_from_hf_dir``, the converted-params cache,
the checkpoint's tokenizer) and decoded greedily by the engine, and the
streams must equal ``transformers``' float32 greedy ``generate`` on the same
prompts: a fault in the key map, RoPE, GQA, the tokenizer or the cache
breaks the equality. It needs ``transformers`` and the checkpoint's
tokenizer files; the engine takes the card unless the caller asks for the
CPU (``device="cpu"``: float32 parity). ``run(checkpoint_dir,
device="cpu")`` returns the report.
"""

from __future__ import annotations

from typing import List

DEFAULT_PROMPTS = (
    "Who are you?",
    "The capital of France is",
    "def fibonacci(n):",
    "Water boils at",
    "List three colors:",
)


def hf_greedy(checkpoint_dir: str, prompts, max_tokens: int
              ) -> List[List[int]]:
    """HuggingFace float32 greedy decode on the CPU: the reference."""
    import torch
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(checkpoint_dir, local_files_only=True)
    model = AutoModelForCausalLM.from_pretrained(
        checkpoint_dir, local_files_only=True,
        torch_dtype=torch.float32).eval()
    outs = []
    with torch.no_grad():
        for p in prompts:
            ids = tok(p, return_tensors="pt").input_ids
            gen = model.generate(ids, max_new_tokens=max_tokens,
                                 do_sample=False, num_beams=1)
            outs.append(gen[0, ids.shape[1]:].tolist())
    return outs


def engine_greedy(checkpoint_dir: str, prompts, max_tokens: int,
                  device=None) -> List[List[int]]:
    """Greedy decode through the serving path: checkpoint load, engine
    prefill and decode (float32 activations, weights as loaded)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import ServingConfig
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Request
    from aws_k8s_ansible_provisioner_tpu_torch.serving.server import \
        build_state

    serving = ServingConfig(checkpoint_dir=checkpoint_dir, model="parity",
                            max_decode_slots=len(prompts),
                            max_cache_len=512,
                            dtype="float32", weights_dtype="auto")
    state = build_state(serving, device=device)
    eng = state.engine
    reqs = [eng.submit(Request(prompt_ids=state.tokenizer.encode(p),
                               max_tokens=max_tokens, ignore_eos=False))
            for p in prompts]
    eng.run_until_idle()
    return [r.generated for r in reqs]


def run(checkpoint_dir: str, prompts=DEFAULT_PROMPTS, max_tokens: int = 16,
        device=None) -> dict:
    """Compare and report. HF stops at eos, so the streams are compared up
    to the shorter one, which must hold at least one token."""
    ref = hf_greedy(checkpoint_dir, prompts, max_tokens)
    got = engine_greedy(checkpoint_dir, prompts, max_tokens, device=device)
    results = []
    ok = True
    for p, r, g in zip(prompts, ref, got):
        n = min(len(r), len(g))
        match = n > 0 and r[:n] == g[:n]
        ok &= match
        results.append({"prompt": p, "match": match, "hf": r, "engine": g})
    return {"ok": ok, "checkpoint": checkpoint_dir,
            "max_tokens": max_tokens, "results": results}

