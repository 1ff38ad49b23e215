"""Mixture-of-Experts MLP (Qwen3-MoE): the router, the two expert
formulations, and the two kernels of the exact one.

The JAX package's ``ops/moe.py``, over torch tensors, with its semantics
and roundings:

- :func:`route`: the router product in float32 (``torch.matmul``; TF32 stays
  off), softmax over all experts, top-k with ties to the lowest expert
  index (``jax.lax.top_k``'s order, and HF's CPU ``torch.topk``'s),
  renormalization by ``max(sum, 1e-9)`` when ``norm_topk_prob``, weights in
  the activation dtype.
- :func:`moe_mlp_ragged` (the default; exact, no token dropped): the N * k
  (token, choice) assignments sorted stably by expert (row r of the sorted
  order is flat assignment ``order[r]``), ``gate`` and ``up`` as grouped
  products over the sorted rows with ``silu(g) * u`` after them, ``down``
  as a grouped product, then each token's k rows times their weights,
  added in ascending expert order with one rounding per add (the JAX
  scatter-add over sorted rows). With int8 experts (``models/quant.py``:
  kernels [E, in, out] int8 beside float32 scales [E, out]) a product is
  rounded to the activation dtype, times its expert's scale row, rounded
  again.
- :func:`moe_mlp_gshard`: fixed-capacity one-hot dispatch and combine as
  plain einsums (the JAX package leaves them to XLA); tokens past an
  expert's capacity (:func:`gshard_capacity` of the N rows handed in,
  padding rows included) add nothing.
- :func:`moe_mlp` picks one by ``cfg.moe_impl``.

The two kernels (``csrc/moe_route.cu``, ``csrc/moe_grouped.cu``) replace no
``pallas_call``: the JAX package leaves ``ragged_dot`` and the routing to
XLA, which fuses the int8 upcast into the grouped product. No single
PyTorch call does that on the card without a host sync (a loop over the
experts needs the group sizes on the host, which breaks the decode graphs)
or a dequantized copy of the experts (29 GB a forward at Qwen3-30B-A3B):

- :func:`route_sort` (``moe_route.cu``) takes the float32 router logits
  [N, E] and, with no sync to the host, gives the weights and experts
  [N, k], the per-expert offsets [E + 1] of the sorted rows, each sorted
  row's source token and expert, and each assignment's sorted position.
  The sort is stable by (expert, flat index), exactly
  ``torch.argsort(flat_experts, stable=True)``: a block-count pass, a
  per-expert scan over the blocks and a scatter, no atomics, so the
  result repeats bit for bit.
- :func:`grouped_matmul` and :func:`grouped_gate_up` (``moe_grouped.cu``)
  compute ``y[r] = x[src(r)] @ W[e(r)]`` over the rows grouped by the
  device offsets (``src``: an optional gather of the input rows, the
  tokens of the sorted rows), bf16 activations over bf16 or int8 experts;
  the int8 instances convert the weights in registers and apply the scale
  in the epilogue with the roundings above, never writing a dequantized
  copy; :func:`grouped_gate_up` takes ``w_gate`` and ``w_up`` in one
  launch and writes ``silu(g) * u``. The weight columns are the MMA's M
  side and an expert's rows its N side (a row tile of up to 32 rows, so a
  decode group of 1 to 8 rows fills one n8 tile). The grid is one CTA an
  SM, fixed by the device, so the decode graphs capture it: each CTA reads
  the offsets on the device and its workers (a warp a weight) walk the
  work items (expert, column tile, row tile); an expert with no rows gives
  no item and costs no byte. A warp owns the whole contraction of its
  tile, so each output sums its products in one float32 chain over k, as
  the plain version's matmul does: the result is the plain one's bit for
  bit and never depends on scheduling. At serving sizes this is a
  bandwidth kernel: the bytes are the touched experts' weights.

Each wrapper takes its plain version (:func:`route_sort_plain`,
:func:`grouped_matmul_plain`, :func:`grouped_gate_up_plain`, which need the
offsets on the host) for CPU tensors only; for CUDA tensors it launches its
kernel or raises, and nothing falls back. Each counts its launches
(``launches``; the int8 instances in ``form_launches["quant"]``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.ops import cuda_build, split_kv

# limits of the CUDA kernels (csrc/moe_route.cu kMaxExperts, kMaxTopK;
# csrc/moe_grouped.cu kMaxExperts, a tile row's 128 bytes of int8
# columns, its 32-deep stages)
MAX_EXPERTS = 256
MAX_TOP_K = 32
GROUPED_TILE_N = 128
GROUPED_TILE_K = 32
# tokens of one block of the route kernel's count pass
# (csrc/moe_route.cu kBlockTokens)
ROUTE_BLOCK_TOKENS = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_WEIGHT_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Routing(NamedTuple):
    """What :func:`route_sort` gives: ``weights`` [N, k] (activation
    dtype) and ``experts`` [N, k] int32 in top-k order; ``offsets`` [E + 1]
    int32, the sorted rows of expert e being ``offsets[e]:offsets[e + 1]``;
    ``row_token`` and ``row_expert`` [N * k] int32, each sorted row's source
    token and expert; ``pos`` [N, k] int32, each assignment's sorted row."""
    weights: torch.Tensor
    experts: torch.Tensor
    offsets: torch.Tensor
    row_token: torch.Tensor
    row_expert: torch.Tensor
    pos: torch.Tensor


def router_logits(x: torch.Tensor, router_kernel: torch.Tensor
                  ) -> torch.Tensor:
    """The float32 router product x [N, H] @ router [H, E]."""
    return torch.matmul(x.float(), router_kernel.float())


def route_plain(logits: torch.Tensor, k: int, norm_topk_prob: bool,
                dtype: torch.dtype):
    """Softmax over all experts, top-k (a stable descending sort: ties to
    the lowest index), the renormalization: (weights [N, k] in ``dtype``,
    experts [N, k] int32)."""
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    if norm_topk_prob:
        w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w.to(dtype), idx.to(torch.int32)


def sort_plain(experts: torch.Tensor, num_experts: int):
    """The stable sort of the flat assignments by expert: (offsets,
    row_token, row_expert, pos) as :class:`Routing` holds them."""
    n, k = experts.shape
    flat = experts.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=num_experts)
    offsets = torch.zeros(num_experts + 1, dtype=torch.int32,
                          device=flat.device)
    offsets[1:] = torch.cumsum(counts, 0)
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device)
    return (offsets, (order // k).to(torch.int32),
            flat[order].to(torch.int32), pos.view(n, k).to(torch.int32))


def route_sort_plain(logits: torch.Tensor, k: int, norm_topk_prob: bool,
                     dtype: torch.dtype) -> Routing:
    """Plain version of :func:`route_sort`."""
    w, idx = route_plain(logits, k, norm_topk_prob, dtype)
    return Routing(w, idx, *sort_plain(idx, logits.shape[-1]))


def _route_lib():
    fn = cuda_build.load("moe_route").moe_route_sort
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                       _P]
        fn.restype = _I
    return fn


def route_sort(logits: torch.Tensor, k: int, norm_topk_prob: bool,
               dtype: torch.dtype) -> Routing:
    """Route the tokens and sort their assignments by expert
    (:class:`Routing`) from the float32 router logits [N, E]. CPU tensors
    take :func:`route_sort_plain`; CUDA tensors launch the route-and-sort
    kernel (E <= MAX_EXPERTS, 1 <= k <= min(E, MAX_TOP_K), weights in
    bf16 or float32) or raise."""
    if logits.device.type == "cpu":
        return route_sort_plain(logits, k, norm_topk_prob, dtype)
    what = "route_sort"
    if logits.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.float32 \
            or not logits.is_contiguous():
        raise TypeError(f"{what}: contiguous float32 logits [N, E] expected, "
                        f"got {logits.dtype} {tuple(logits.shape)}")
    n, e = logits.shape
    if not 1 <= e <= MAX_EXPERTS or not 1 <= k <= min(e, MAX_TOP_K):
        raise ValueError(f"{what}: E {e}, k {k} not taken (E <= "
                         f"{MAX_EXPERTS}, k <= min(E, {MAX_TOP_K}))")
    if n * k >= 2**31:
        raise ValueError(f"{what}: {n} x {k} assignments exceed int32")
    if dtype not in _WEIGHT_CODES:
        raise TypeError(f"{what}: weights in {dtype} not taken")
    dev = logits.device
    i32 = dict(dtype=torch.int32, device=dev)
    out = Routing(torch.empty((n, k), dtype=dtype, device=dev),
                  torch.empty((n, k), **i32), torch.empty(e + 1, **i32),
                  torch.empty(n * k, **i32), torch.empty(n * k, **i32),
                  torch.empty((n, k), **i32))
    if n == 0:
        out.offsets.zero_()
        return out
    blocks = -(-n // ROUTE_BLOCK_TOKENS)
    counts = torch.empty((blocks, e), **i32)
    with torch.cuda.device(dev):
        rc = _route_lib()(logits.data_ptr(), n, e, k, int(norm_topk_prob),
                          out.weights.data_ptr(), _WEIGHT_CODES[dtype],
                          out.experts.data_ptr(), out.offsets.data_ptr(),
                          out.row_token.data_ptr(), out.row_expert.data_ptr(),
                          out.pos.data_ptr(), counts.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    route_sort.launches += 1
    return out


def route(cfg: ModelConfig, x: torch.Tensor, router_kernel: torch.Tensor):
    """Top-k routing of x [N, H] by router [H, E]: (weights [N, k] in
    x.dtype, experts [N, k] int32), the JAX ``route``."""
    r = route_sort(router_logits(x, router_kernel), cfg.num_experts_per_tok,
                   cfg.norm_topk_prob, x.dtype)
    return r.weights, r.experts


def _expert_mm(v: torch.Tensor, kernel: torch.Tensor,
               scale: Optional[torch.Tensor]) -> torch.Tensor:
    """One expert's product; int8: rounded to v's dtype, times the scale
    row, rounded again."""
    if scale is not None:
        return ((v @ kernel.to(v.dtype)) * scale).to(v.dtype)
    return v @ kernel


def grouped_matmul_plain(x: torch.Tensor, p: dict, offsets: torch.Tensor,
                         row_src: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of :func:`grouped_matmul`: a loop over the experts
    (the offsets read on the host)."""
    xs = x if row_src is None else x[row_src.long()]
    kernel, scale = p["kernel"], p.get("scale")
    out = xs.new_empty((xs.shape[0], kernel.shape[-1]))
    off = offsets.tolist()
    for e in range(kernel.shape[0]):
        a, b = off[e], off[e + 1]
        if b > a:
            out[a:b] = _expert_mm(xs[a:b], kernel[e],
                                  None if scale is None else scale[e])
    return out


def grouped_gate_up_plain(x: torch.Tensor, p_gate: dict, p_up: dict,
                          offsets: torch.Tensor,
                          row_src: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of :func:`grouped_gate_up`: silu(g) * u of the two
    grouped products."""
    g = grouped_matmul_plain(x, p_gate, offsets, row_src)
    u = grouped_matmul_plain(x, p_up, offsets, row_src)
    return F.silu(g) * u


def _grouped_lib():
    fn = cuda_build.load("moe_grouped").moe_grouped
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                       _I, _P]
        fn.restype = _I
    return fn


def _check_expert(what, p, e, k_in, n_out, dev):
    kernel, scale = p["kernel"], p.get("scale")
    if kernel.shape != (e, k_in, n_out) or kernel.device != dev \
            or not kernel.is_contiguous() or kernel.data_ptr() % 16:
        raise ValueError(f"{what}: expert kernels {tuple(kernel.shape)} on "
                         f"{kernel.device}, expected contiguous and 16-byte "
                         f"aligned {(e, k_in, n_out)} on {dev}")
    if scale is None:
        if kernel.dtype != torch.bfloat16:
            raise TypeError(f"{what}: bf16 or int8 expert kernels expected, "
                            f"got {kernel.dtype}")
        return
    if kernel.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.shape != (e, n_out) or not scale.is_contiguous() \
            or scale.device != dev:
        raise TypeError(f"{what}: int8 kernels with contiguous float32 "
                        f"scales [E, out] expected")


def _grouped(what, x, p0, p1, offsets, row_src):
    """Checks and the launch of :func:`grouped_matmul` (``p1`` None) or
    :func:`grouped_gate_up`."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    dev = x.device
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"{what}: contiguous bf16 rows [N, K] expected, got "
                        f"{x.dtype} {tuple(x.shape)}")
    e, k_in, n_out = p0["kernel"].shape
    if x.shape[1] != k_in or k_in % GROUPED_TILE_K or n_out % GROUPED_TILE_N:
        raise ValueError(f"{what}: K {x.shape[1]} against kernels "
                         f"{tuple(p0['kernel'].shape)} (K and out must be "
                         f"multiples of {GROUPED_TILE_K} and "
                         f"{GROUPED_TILE_N})")
    if e > MAX_EXPERTS:
        raise ValueError(f"{what}: {e} experts (at most {MAX_EXPERTS})")
    quant = "scale" in p0
    for p in (p0,) if p1 is None else (p0, p1):
        if ("scale" in p) != quant:
            raise TypeError(f"{what}: gate and up differ in their dtype")
        _check_expert(what, p, e, k_in, n_out, dev)
    if offsets.shape != (e + 1,) or offsets.dtype != torch.int32 \
            or offsets.device != dev:
        raise ValueError(f"{what}: int32 offsets [{e + 1}] on {dev} "
                         f"expected")
    if row_src is not None and (row_src.dim() != 1
                                or row_src.dtype != torch.int32
                                or not row_src.is_contiguous()
                                or row_src.device != dev):
        raise ValueError(f"{what}: contiguous int32 row sources expected")
    m = x.shape[0] if row_src is None else row_src.shape[0]
    out = torch.empty((m, n_out), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out, quant

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = _grouped_lib()(
            x.data_ptr(), ptr(row_src), m, k_in, n_out, e,
            p0["kernel"].data_ptr(), ptr(p0.get("scale")),
            None if p1 is None else p1["kernel"].data_ptr(),
            None if p1 is None else ptr(p1.get("scale")), int(quant),
            offsets.data_ptr(), out.data_ptr(), split_kv.sm_count(dev),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return out, quant


def grouped_matmul(x: torch.Tensor, p: dict, offsets: torch.Tensor,
                   row_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [M, out] with y[r] = x[src(r)] @ W[e] for the sorted rows r of
    expert e (``offsets``), src(r) = ``row_src[r]`` or r; ``p`` is one
    layer's expert leaf ({"kernel" [E, K, out]} bf16, or int8 beside
    "scale" [E, out] float32). CPU tensors take
    :func:`grouped_matmul_plain`; CUDA tensors (bf16 x, K a multiple of
    32 and out of 128, at most MAX_EXPERTS experts) launch the grouped
    kernel or raise."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, p, offsets, row_src)
    out, quant = _grouped("grouped_matmul", x, p, None, offsets, row_src)
    if out.shape[0]:
        if quant:
            grouped_matmul.form_launches["quant"] += 1
        else:
            grouped_matmul.launches += 1
    return out


def grouped_gate_up(x: torch.Tensor, p_gate: dict, p_up: dict,
                    offsets: torch.Tensor,
                    row_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu(x[src] @ Wg[e]) * (x[src] @ Wu[e]) [M, I] over the sorted rows
    in one launch (the gate and up leaves as in :func:`grouped_matmul`).
    CPU tensors take :func:`grouped_gate_up_plain`."""
    if x.device.type == "cpu":
        return grouped_gate_up_plain(x, p_gate, p_up, offsets, row_src)
    out, quant = _grouped("grouped_gate_up", x, p_gate, p_up, offsets,
                          row_src)
    if out.shape[0]:
        if quant:
            grouped_gate_up.form_launches["quant"] += 1
        else:
            grouped_gate_up.launches += 1
    return out


def combine(ys: torch.Tensor, weights: torch.Tensor, pos: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """out [N, H]: each token's k sorted rows of ``ys`` [N * k, H] times
    their weights (rounded to ``dtype``), added in ascending sorted order
    (ascending expert) with one rounding per add: the JAX scatter-add."""
    n, k = pos.shape
    pos_sorted, perm = torch.sort(pos, dim=1)
    w = torch.gather(weights, 1, perm)
    c = (ys.index_select(0, pos_sorted.reshape(-1)).view(n, k, -1)
         * w[..., None]).to(dtype)
    out = c[:, 0]
    for j in range(1, k):
        out = out + c[:, j]
    return out


def moe_mlp_ragged(cfg: ModelConfig, x: torch.Tensor, p: dict
                   ) -> torch.Tensor:
    """Exact no-drop MoE MLP. x: [N, H] flattened tokens -> [N, H]."""
    r = route_sort(router_logits(x, p["router"]["kernel"]),
                   cfg.num_experts_per_tok, cfg.norm_topk_prob, x.dtype)
    a = grouped_gate_up(x, p["w_gate"], p["w_up"], r.offsets, r.row_token)
    ys = grouped_matmul(a, p["w_down"], r.offsets)
    return combine(ys, r.weights, r.pos, x.dtype)


def gshard_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert token capacity: cf * ceil(N*k/E), floor 4, rounded up to a
    multiple of 4."""
    mean = -(-n_tokens * cfg.num_experts_per_tok // cfg.num_experts)
    cap = max(4, int(mean * cfg.moe_capacity_factor))
    return -(-cap // 4) * 4


def _gshard_route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """The gshard dispatch of x [N, H]: (combine weights [N, E, C], the
    experts' inputs [E, C, H]), C = :func:`gshard_capacity` slots an
    expert filled in arrival order (token-major), in x's dtype."""
    n = x.shape[0]
    E = cfg.num_experts
    C = gshard_capacity(cfg, n)
    w, idx = route(cfg, x, router)
    onehot_e = F.one_hot(idx.reshape(-1).long(), E).to(torch.int32)
    pos = torch.cumsum(onehot_e, dim=0, dtype=torch.int32) - onehot_e
    pos = (pos * onehot_e).sum(-1).reshape(n, -1)                # [N, k]
    keep = (pos < C).to(x.dtype)
    # positions past C are one-hot to nothing (jax.nn.one_hot's zero row)
    onehot_c = (pos.long()[..., None]
                == torch.arange(C, device=x.device)).to(x.dtype)
    oe = onehot_e.reshape(n, -1, E).to(x.dtype)
    combine_w = torch.einsum("nk,nke,nkc->nec", w * keep, oe, onehot_c)
    dispatch = torch.einsum("nk,nke,nkc->nec", keep, oe, onehot_c)
    return combine_w, torch.einsum("nec,nh->ech", dispatch, x)


def moe_mlp_gshard(cfg: ModelConfig, x: torch.Tensor, p: dict
                   ) -> torch.Tensor:
    """Fixed-capacity dispatch MoE MLP. x: [N, H] -> [N, H]; a token's
    assignment past its expert's capacity (arrival order, token-major)
    adds nothing."""
    combine_w, xe = _gshard_route(cfg, x, p["router"]["kernel"])
    g = _gshard_mm("ech,ehi->eci", xe, p["w_gate"])
    u = _gshard_mm("ech,ehi->eci", xe, p["w_up"])
    y = _gshard_mm("eci,eih->ech", F.silu(g) * u, p["w_down"])
    return torch.einsum("nec,ech->nh", combine_w, y).to(x.dtype)


def moe_mlp_gshard_sharded(cfg: ModelConfig, x: torch.Tensor,
                           router: torch.Tensor, experts, devices
                           ) -> torch.Tensor:
    """:func:`moe_mlp_gshard` with the experts over an (ep, tp) grid (the
    JAX engine's gshard under GSPMD with ``w_gate``/``w_up`` split
    ``(ep, tp)`` on (expert, out) and ``w_down`` on (expert, in)):
    ``experts[e][t]`` holds position (e, t)'s layer leaves (E / ep experts,
    I / tp intermediate columns), on ``devices[e][t]``. The routing, the
    dispatch and the combine weights are computed once on x's device (the
    router is replicated); each position runs gate and up over its columns
    and its partial of down; the partials are summed over tp in shard
    order, the int8 scale of down applied after the sum; each ep shard
    combines its experts' outputs, and those are summed over ep in shard
    order on x's device. Returns [N, H] in x's dtype."""
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.collectives import \
        all_reduce

    combine_w, xe = _gshard_route(cfg, x, router)
    el = cfg.num_experts // len(experts)
    outs = []
    for e, (row, devs) in enumerate(zip(experts, devices)):
        span = slice(e * el, (e + 1) * el)
        parts = []
        for p, dev in zip(row, devs):
            xe_p = xe[span].to(dev)
            g = _gshard_mm("ech,ehi->eci", xe_p, p["w_gate"])
            u = _gshard_mm("ech,ehi->eci", xe_p, p["w_up"])
            parts.append(torch.einsum("eci,eih->ech", F.silu(g) * u,
                                      p["w_down"]["kernel"].to(x.dtype)))
        y = all_reduce(parts, devs)[0]
        down = row[0]["w_down"]
        if "scale" in down:
            y = (y * down["scale"][:, None, :]).to(x.dtype)
        outs.append(torch.einsum("nec,ech->nh", combine_w[:, span]
                                 .to(y.device), y))
    return all_reduce(outs, [x.device])[0].to(x.dtype)


def _gshard_mm(spec: str, v: torch.Tensor, q: dict) -> torch.Tensor:
    """One gshard expert product in v's dtype (int8 experts dequantized
    to it, their scale [E, out] applied after)."""
    if "scale" in q:
        out = torch.einsum(spec, v, q["kernel"].to(v.dtype))
        return (out * q["scale"][:, None, :]).to(v.dtype)
    return torch.einsum(spec, v, q["kernel"])


def moe_mlp(cfg: ModelConfig, x: torch.Tensor, p: dict) -> torch.Tensor:
    """Dispatch on cfg.moe_impl. x: [N, H] flattened tokens."""
    if cfg.moe_impl == "gshard":
        return moe_mlp_gshard(cfg, x, p)
    if cfg.moe_impl == "ragged":
        return moe_mlp_ragged(cfg, x, p)
    raise ValueError(f"moe_impl={cfg.moe_impl!r}: expected 'ragged' or "
                     f"'gshard'")


_COUNTED = (route_sort, grouped_matmul, grouped_gate_up)
_QUANT = (grouped_matmul, grouped_gate_up)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    for fn in _QUANT:
        fn.form_launches = collections.Counter()


reset_launch_counts()


def counted_wrappers() -> tuple:
    """The wrappers whose launches this module counts (``launches`` and,
    for the int8 instances, ``form_launches["quant"]``)."""
    return _COUNTED


def launch_counts() -> dict:
    """{"moe_route_sort", "moe_grouped", "moe_grouped quant",
    "moe_gate_up", "moe_gate_up quant": launches}."""
    return {"moe_route_sort": route_sort.launches,
            "moe_grouped": grouped_matmul.launches,
            "moe_grouped quant": grouped_matmul.form_launches["quant"],
            "moe_gate_up": grouped_gate_up.launches,
            "moe_gate_up quant": grouped_gate_up.form_launches["quant"]}
