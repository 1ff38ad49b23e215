"""OpenAI-compatible HTTP server of the PyTorch port.

``GET /v1/models``, ``POST /v1/completions`` (non-streaming; the JSON fields
of the JAX server's completions response; the OpenAI ``seed`` makes a
sampled completion repeatable) and ``GET /health``, over a
``ThreadingHTTPServer`` with the engine stepping on its own thread.

A completions request reads ``prompt``, ``max_tokens``, ``temperature``,
``top_k``, ``top_p``, ``ignore_eos`` and ``seed``. Every other request
field that the JAX server honours is refused with 400, naming the field,
unless it holds its neutral value (:data:`UNSERVED_FIELDS`): a completion
that silently ignored it would be a wrong answer.

Without a checkpoint the server runs seeded random weights and the byte
tokenizer, as the JAX server does without ``--checkpoint-dir``::

    python -m aws_k8s_ansible_provisioner_tpu_torch.serving.server \\
        --model Qwen/Qwen3-0.6B --device cuda

Any model of ``config.MODEL_REGISTRY`` serves this way, e.g. ``--model
mistralai/Mistral-7B-v0.1`` (sliding-window attention; with int8 weights
about 7.3 GB on the card).
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

log = logging.getLogger(__name__)


def _number(x):
    """x as a float when it is a JSON number (not a boolean), else None."""
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return None
    return float(x)


def _is_number(value):
    return lambda x: _number(x) == value


# The JAX server's completions fields the port does not serve yet (its
# serving/server.py:738-954), each with the test of its neutral value: a
# request that sets one of them to anything else is refused. null (or the
# field left out) is neutral for every one.
UNSERVED_FIELDS = {
    "stop": lambda x: x == "" or x == [],
    "stop_token_ids": lambda x: x == [],
    "min_tokens": _is_number(0.0),
    "n": _is_number(1.0),
    # best_of must equal n, and n is refused unless it is 1
    "best_of": _is_number(1.0),
    "echo": lambda x: x is False,
    "prompt_logprobs": lambda x: False,
    "logprobs": lambda x: x is False,
    "top_logprobs": _is_number(0.0),
    "logit_bias": lambda x: x == {},
    "presence_penalty": _is_number(0.0),
    "frequency_penalty": _is_number(0.0),
    "repetition_penalty": _is_number(1.0),
    "resume_token_ids": lambda x: False,
    "response_format": lambda x: isinstance(x, dict) and set(x) <= {"type"}
    and x.get("type") in (None, "text"),
    "guided_json": lambda x: False,
    "guided_regex": lambda x: False,
    "guided_choice": lambda x: False,
}


def unserved_field(body: dict) -> Optional[str]:
    """The first field of :data:`UNSERVED_FIELDS` that ``body`` sets to a
    value other than null or its neutral one, or None."""
    for name, neutral in UNSERVED_FIELDS.items():
        value = body.get(name)
        if value is not None and not neutral(value):
            return name
    return None


class ServerState:
    """What the request handlers share: engine, tokenizer, served name."""

    def __init__(self, engine, tokenizer, model_name: str):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.started = int(time.time())
        self.stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start_engine(self):
        self._thread = threading.Thread(target=self.engine.run_forever,
                                        args=(self.stop,), daemon=True,
                                        name="engine-step")
        self._thread.start()

    def stop_engine(self, timeout: float = 10.0):
        self.stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


def build_state(serving=None, model_cfg=None, params=None, tokenizer=None,
                device=None, seed: int = 0) -> ServerState:
    """Wire tokenizer, params and engine into a ServerState. Without a
    checkpoint: random weights from ``seed`` and the byte tokenizer. A
    ``serving.mesh`` of more than one device takes that many CUDA cards
    (the engine's ``_build_mesh``), or on the CPU repeats the CPU."""
    import torch

    from aws_k8s_ansible_provisioner_tpu_torch.config import (
        MODEL_REGISTRY, ServingConfig, tiny_qwen3)
    from aws_k8s_ansible_provisioner_tpu_torch.device import resolve_device
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import init_params
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params
    from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import Engine
    from aws_k8s_ansible_provisioner_tpu_torch.utils.tokenizer import (
        load_tokenizer)

    serving = serving or ServingConfig()
    dev = resolve_device(device)
    tokenizer = tokenizer or load_tokenizer()
    if model_cfg is None:
        if serving.model in MODEL_REGISTRY:
            model_cfg = MODEL_REGISTRY[serving.model]
        elif serving.model == "tiny-qwen3":
            # offline dry-run model sized to the byte tokenizer
            model_cfg = tiny_qwen3(vocab_size=tokenizer.vocab_size,
                                   eos_token_id=tokenizer.eos_token_id,
                                   num_layers=4, hidden_size=128,
                                   intermediate_size=256)
        else:
            raise ValueError(f"unknown model {serving.model!r}")
    dtype = torch.bfloat16 if serving.dtype == "bfloat16" else torch.float32
    if params is None:
        log.warning("no checkpoint: serving RANDOM weights (%s, seed %d)",
                    model_cfg.name, seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(model_cfg, gen, dtype)
        if serving.weights_dtype == "int8":
            # drop the unquantized tree before the engine sizes its pool
            params = quantize_params(params, model_cfg)
    mesh = None
    if dev.type == "cpu" and serving.mesh.num_devices > 1:
        # a dry run on the CPU: every shard of the mesh on the CPU
        mesh = make_mesh(serving.mesh, [dev] * serving.mesh.num_devices)
    engine = Engine(model_cfg, params, serving, device=dev, mesh=mesh)
    return ServerState(engine, tokenizer, serving.model)


class Handler(BaseHTTPRequestHandler):
    state: ServerState = None          # set by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, etype: str = "invalid_request_error"):
        self._json(code, {"error": {"message": message, "type": etype,
                                    "code": code}})

    def do_GET(self):
        path = self.path.split("?")[0]
        st = self.state
        if path == "/v1/models":
            self._json(200, {"object": "list", "data": [{
                "id": st.model_name, "object": "model",
                "created": st.started, "owned_by": "torch-serve",
                "max_model_len": st.engine.max_len}]})
        elif path == "/health":
            eng = st.engine
            self._json(200, {"status": "error" if eng.last_error else "ok",
                             "last_error": eng.last_error,
                             "device": str(eng.device),
                             "active": len(eng._active_slots()),
                             "queued": eng.pending})
        else:
            self._error(404, f"no route {path}")

    def do_POST(self):
        path = self.path.split("?")[0]
        if path != "/v1/completions":
            return self._error(404, f"no route {path}")
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return self._error(400, "request body is not valid JSON")
        if not isinstance(body, dict):
            return self._error(400, "request body must be a JSON object")
        self._completions(body)

    def _completions(self, body: dict):
        from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import (
            ContextLengthExceeded, EngineOverloaded, Request)

        st = self.state
        if body.get("stream"):
            return self._error(400, "streaming is not supported yet")
        field = unserved_field(body)
        if field is not None:
            return self._error(400, f"'{field}' is not supported yet (only "
                                    f"its neutral value is accepted)")
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and all(isinstance(t, int)
                                            for t in prompt):
            ids = list(prompt)
        elif isinstance(prompt, str):
            ids = st.tokenizer.encode(prompt)
        else:
            return self._error(400, "prompt must be a string or a list of "
                                    "token ids")
        seed = body.get("seed")
        if seed is not None:
            try:
                seed = int(seed)
            except (TypeError, ValueError):
                return self._error(400, "'seed' must be an integer")
        try:
            req = Request(
                prompt_ids=ids,
                max_tokens=int(body.get(
                    "max_tokens", st.engine.serving.max_tokens_default)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0) or 0),
                top_p=float(body.get("top_p", 1.0)),
                ignore_eos=bool(body.get("ignore_eos", False)),
                seed=seed)
            if req.max_tokens < 1:
                raise ValueError("max_tokens must be >= 1")
            st.engine.submit(req)
        except ContextLengthExceeded as e:
            return self._error(400, str(e))
        except EngineOverloaded as e:
            return self._error(429, str(e), "overloaded_error")
        except (TypeError, ValueError) as e:
            return self._error(400, str(e))
        req.wait()
        if req.finish_reason in ("error", "cancelled"):
            return self._error(500, "engine failure: "
                               + (st.engine.last_error or req.finish_reason),
                               "internal_error")
        n_prompt, n_gen = len(ids), len(req.generated)
        self._json(200, {
            "id": f"cmpl-{uuid.uuid4().hex}", "object": "text_completion",
            "created": int(time.time()),
            "model": body.get("model") or st.model_name,
            "choices": [{"index": 0,
                         "text": st.tokenizer.decode(req.generated),
                         "logprobs": None,
                         "finish_reason": req.finish_reason}],
            "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_gen,
                      "total_tokens": n_prompt + n_gen}})


def make_server(state: ServerState, host: str, port: int
                ) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (Handler,), {"state": state})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def main(argv=None):
    from aws_k8s_ansible_provisioner_tpu_torch.config import (MeshConfig,
                                                              ServingConfig)

    p = argparse.ArgumentParser(description="OpenAI-compatible LLM server "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--model", default="Qwen/Qwen3-0.6B",
                   help="a registered model (Qwen/Qwen3-0.6B, "
                        "mistralai/Mistral-7B-v0.1), or tiny-qwen3 "
                        "(byte-vocab dry run)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu for a dry run)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-decode-slots", type=int, default=32)
    p.add_argument("--max-cache-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--weights-dtype", default="int8",
                   choices=["int8", "bf16", "auto"])
    p.add_argument("--kv-dtype", default="auto", choices=["auto", "int8"],
                   help="KV pool: auto = --dtype; int8 = per-row int8 with "
                        "float32 scales")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill size; 0 disables")
    p.add_argument("--decode-bblock", type=int, default=0,
                   help="slots per CTA of the dense cache's decode kernel "
                        "(fitted to a divisor of the slots; 0 = 1); the "
                        "paged engine's kernel takes none")
    p.add_argument("--decode-pipeline", type=int, default=1,
                   help="one-deep decode pipeline: dispatch N+1 is queued "
                        "before N's tokens are fetched (seeded streams "
                        "unchanged); 0 = synchronous dispatch then fetch")
    p.add_argument("--spec-decode", action="store_true",
                   help="prompt-lookup speculative decoding (greedy streams "
                        "unchanged)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens verified per speculative step")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: the dense KV cache's "
                        "sequence axis split over sp cards, decode merging "
                        "the shards' flash partials (needs sp cards; with "
                        "--device cpu every shard on the CPU)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    serving = ServingConfig(
        model=args.model, port=args.port, host=args.host,
        max_decode_slots=args.max_decode_slots,
        max_cache_len=args.max_cache_len, page_size=args.page_size,
        dtype=args.dtype, weights_dtype=args.weights_dtype,
        kv_dtype=args.kv_dtype, prefill_chunk=args.prefill_chunk,
        decode_bblock=args.decode_bblock,
        decode_pipeline=args.decode_pipeline, spec_decode=args.spec_decode,
        spec_k=args.spec_k, mesh=MeshConfig(sp=args.sp))
    state = build_state(serving, device=args.device, seed=args.seed)
    server = make_server(state, args.host, args.port)
    state.start_engine()
    log.info("serving %s on %s:%d (%s)", args.model, args.host, args.port,
             state.engine.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        state.stop_engine()


if __name__ == "__main__":
    main()
