"""How the parameters and the serving caches are laid out over a mesh.

The JAX package states its layouts as ``PartitionSpec``s (its
``parallel/sharding.py``) and lets GSPMD place the slices and insert the
collectives. The port states the same layouts as tuples, one entry a leaf
axis (``None`` or the mesh axis it is split over), and slices the leaves
itself:

- :func:`param_pspecs` (`:118-140` there; :func:`_layer_pspecs` `:52-115`):
  Megatron tensor parallelism. Column-parallel kernels (``wq``, ``wk``,
  ``wv``, ``w_gate``, ``w_up``; weights are ``[L, in, out]``) split their
  out axis over ``tp``, with their bias and int8 ``scale``; row-parallel
  kernels (``wo``, ``w_down``) split their in axis, their bias and scale
  replicated (the scale is per out column, and the out axis is whole). The
  embedding (with its per-row int8 scale) and an untied ``lm_head`` are
  split over the vocabulary. Norms, q/k norms, OPT's positions and the MoE
  router are replicated. MoE experts ``[L, E, in, out]`` split over ``ep``,
  each expert over ``tp`` like the dense MLP.
- :func:`shard_params` (`:194-202`) and :func:`make_sharded_put`
  (`:205-234`, the loader's per-leaf placement callback): every leaf
  becomes a :class:`ShardedLeaf`, one slice a mesh position, each slice
  copied to that position's device on its own, so a device never holds a
  whole leaf that the layout splits. Positions that share a device and a
  slice share one tensor (a one-card mesh holds each slice once).
- :func:`init_pool_sharded` (the paged pool's ``pool_pspecs`` `:160-180`:
  pages over dp, kv heads over tp): one ``[L, group_pages + 1, Hkv / tp,
  page, D]`` pool (and the int8 scale leaves alike) per (dp group, tp
  shard), allocated on its device, never split from a whole pool
  (:class:`ShardedPool`).
- :func:`init_cache_sharded`: the dense cache of the sequence-parallel
  engine, ``[L, slots, Hkv, S / sp, D]`` per ``sp`` shard; shard i holds
  the global rows ``[i * S_local, (i + 1) * S_local)``; each row keeps its
  own int8 scale, so the quantized bits do not depend on the sharding.

Shard after ``quantize_params``, as the JAX engine does: a column-parallel
slice of a quantized kernel is then the quantization of that slice, bit
for bit (its scales are per out column), and a row-parallel kernel keeps
the whole kernel's scale.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc

Spec = Tuple[Optional[str], ...]


def check_tp_divisibility(cfg: ModelConfig, tp: int, ep: int = 1) -> None:
    """TP must evenly split query heads, kv heads, the vocabulary and the
    MLP intermediate (the MoE expert intermediate when sparse); ep must
    split the experts (the JAX package's rule)."""
    dims = [("num_heads", cfg.num_heads),
            ("num_kv_heads", cfg.num_kv_heads),
            ("vocab_size", cfg.vocab_size)]
    if cfg.num_experts > 0:
        dims.append(("moe_intermediate_size", cfg.moe_intermediate_size))
    else:
        dims.append(("intermediate_size", cfg.intermediate_size))
    for name, dim in dims:
        if dim % tp != 0:
            raise ValueError(f"tp={tp} does not divide {name}={dim} "
                             f"for model {cfg.name}")
    if ep > 1 and cfg.num_experts % ep != 0:
        raise ValueError(f"ep={ep} does not divide num_experts="
                         f"{cfg.num_experts} for model {cfg.name}")


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 without a mesh)."""
    return mesh.shape.get(name, 1) if mesh is not None else 1


def sp_size(mesh) -> int:
    """The mesh's sequence-parallel size (1 without a mesh)."""
    return axis_size(mesh, "sp")


# -- layouts -----------------------------------------------------------------


def _layer_pspecs(cfg: ModelConfig, quant_weights: bool = False) -> dict:
    """Specs of the stacked layer leaves (``models/layers.init_params``'s
    tree; with ``quant_weights`` the int8 ``scale`` leaves too)."""

    def col(bias: bool) -> dict:            # [L, in, out]: split out
        p = {"kernel": (None, None, "tp")}
        if bias:
            p["bias"] = (None, "tp")
        if quant_weights:
            p["scale"] = (None, "tp")
        return p

    def row(bias: bool) -> dict:            # [L, in, out]: split in
        p = {"kernel": (None, "tp", None)}
        if bias:
            p["bias"] = (None, None)
        if quant_weights:
            p["scale"] = (None, None)
        return p

    def norm() -> dict:
        p = {"weight": (None, None)}
        if cfg.norm == "layernorm":
            p["bias"] = (None, None)
        return p

    specs = {"input_norm": norm(), "wq": col(cfg.attention_bias),
             "wk": col(cfg.attention_bias), "wv": col(cfg.attention_bias),
             "wo": row(cfg.attention_bias)}
    if cfg.qk_norm:
        specs["q_norm"] = {"weight": (None, None)}
        specs["k_norm"] = {"weight": (None, None)}
    if cfg.num_experts > 0:
        # experts over ep, each expert Megatron-split over tp; scales
        # [L, E, out] follow their kernel's expert and out axes
        specs["router"] = {"kernel": (None, None, None)}
        specs["w_gate"] = {"kernel": (None, "ep", None, "tp")}
        specs["w_up"] = {"kernel": (None, "ep", None, "tp")}
        specs["w_down"] = {"kernel": (None, "ep", "tp", None)}
        if quant_weights:
            specs["w_gate"]["scale"] = (None, "ep", "tp")
            specs["w_up"]["scale"] = (None, "ep", "tp")
            specs["w_down"]["scale"] = (None, "ep", None)
    else:
        if cfg.gated_mlp:
            specs["w_gate"] = col(cfg.mlp_bias)
        specs["w_up"] = col(cfg.mlp_bias)
        specs["w_down"] = row(cfg.mlp_bias)
    if not cfg.parallel_block:
        specs["post_norm"] = norm()
    return specs


def param_pspecs(cfg: ModelConfig, quant_weights: bool = False) -> dict:
    """The whole tree's specs (``init_params``'s structure; with
    ``quant_weights`` ``quantize_params``'s)."""
    specs: dict = {"embed": {"weight": ("tp", None)},
                   "layers": _layer_pspecs(cfg, quant_weights),
                   "final_norm": {"weight": (None,)}}
    if quant_weights:
        specs["embed"]["scale"] = ("tp",)
    if cfg.pos_embed == "learned":
        specs["pos_embed"] = {"weight": (None, None)}
    if cfg.norm == "layernorm":
        specs["final_norm"]["bias"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"kernel": (None, "tp")}
        if cfg.parallel_block:
            specs["lm_head"]["bias"] = ("tp",)
        if quant_weights:
            specs["lm_head"]["scale"] = ("tp",)
    return specs


# -- sharded parameters ------------------------------------------------------


class ShardedLeaf:
    """One leaf over the mesh: ``parts[pos]`` is its slice at mesh
    position ``pos`` (an index into ``mesh.devices``), on that position's
    device; ``shape`` is the whole leaf's and ``spec`` its layout."""

    def __init__(self, parts: dict, shape: tuple, spec: Spec):
        self.parts, self.shape, self.spec = parts, tuple(shape), spec


def _slice_index(spec: Spec, mesh, pos: tuple) -> tuple:
    """The slice of a leaf at mesh position ``pos``: its index along each
    split axis of ``spec``."""
    return tuple(pos[mesh.axis_names.index(a)] if a is not None else 0
                 for a in spec)


def _slice(arr: torch.Tensor, spec: Spec, mesh, index: tuple
           ) -> torch.Tensor:
    for dim, (axis, i) in enumerate(zip(spec, index)):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if arr.shape[dim] % n:
            raise ValueError(f"axis {dim} of a {tuple(arr.shape)} leaf does "
                             f"not split over {axis}={n}")
        size = arr.shape[dim] // n
        arr = arr.narrow(dim, i * size, size)
    return arr


def shard_leaf(arr: torch.Tensor, spec: Spec, mesh) -> ShardedLeaf:
    """``arr`` sliced by ``spec`` onto every position of ``mesh``: each
    slice is copied to its device on its own (a split slice never shares
    the whole leaf's storage), once per (slice, device)."""
    if len(spec) != arr.dim():
        raise ValueError(f"spec {spec} for a {tuple(arr.shape)} leaf")
    split = any(a is not None and mesh.shape[a] > 1 for a in spec)
    made: Dict[tuple, torch.Tensor] = {}
    parts = {}
    for pos in itertools.product(*(range(n) for n in mesh.devices.shape)):
        dev = mesh.devices[pos]
        index = _slice_index(spec, mesh, pos)
        key = (index, str(dev))
        if key not in made:
            part = _slice(arr, spec, mesh, index).to(dev)
            if split and part.untyped_storage().data_ptr() == \
                    arr.untyped_storage().data_ptr():
                part = part.clone()
            made[key] = part.contiguous()
        parts[pos] = made[key]
    return ShardedLeaf(parts, arr.shape, spec)


def _spec_of(specs: dict, path: Tuple[str, ...], ndim: int) -> Spec:
    node = specs
    for key in path:
        node = node.get(key) if isinstance(node, dict) else None
        if node is None:
            # a leaf the layout does not name: replicated (never dropped)
            return (None,) * ndim
    return node


def make_sharded_put(mesh, cfg: ModelConfig, quant_weights: bool = True
                     ) -> Callable:
    """The per-leaf placement callback of ``models/hf_loader.
    load_checkpoint(place=...)`` and ``models/checkpoint.restore_params``:
    ``put(path, leaf)`` with ``path`` the leaf's keys in the tree
    (``("layers", "wq", "kernel")``) returns its :class:`ShardedLeaf`. The
    specs include the int8 scale leaves, so one callback serves bf16 and
    int8 trees."""
    specs = param_pspecs(cfg, quant_weights=quant_weights)

    def put(path: Tuple[str, ...], arr: torch.Tensor) -> ShardedLeaf:
        return shard_leaf(arr, _spec_of(specs, tuple(path), arr.dim()), mesh)

    return put


def map_tree(fn, tree: dict, path: tuple = ()) -> dict:
    """``fn(path, leaf)`` over every leaf of a nested dict."""
    return {k: map_tree(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def is_sharded(tree: dict) -> bool:
    """Whether the tree's leaves are :class:`ShardedLeaf`."""
    node = tree
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return isinstance(node, ShardedLeaf)


def shard_params(params: dict, mesh, cfg: ModelConfig) -> dict:
    """Place a whole parameter tree onto the mesh by the layout (a tree of
    :class:`ShardedLeaf`; a tree already sharded is returned as it is)."""
    if is_sharded(params):
        return params
    return map_tree(make_sharded_put(mesh, cfg), params)


def position_tree(tree: dict, pos: tuple) -> dict:
    """The plain tree of one mesh position's slices."""
    return map_tree(lambda _, leaf: leaf.parts[pos], tree)


# -- the paged pool ----------------------------------------------------------


class ShardedPool:
    """The paged pool over a (dp, tp) mesh: ``parts[g][t]`` is dp group
    g's partition of tp shard t's kv heads, a ``paged_kv.init_pool`` dict
    ``[L, group_pages, Hkv / tp, page, D]`` on ``devices[g][t]``. Page ids
    outside the pool are GLOBAL: ``local + g * group_pages``, page 0 of
    each partition its group's scratch page. :meth:`gather` and
    :meth:`restore` move whole pages (all heads) for the host tier, whose
    payloads are ``[L, Hkv, page, (D)]`` as the unsharded pool's."""

    def __init__(self, parts: List[List[dict]], devices: List[list],
                 group_pages: int, lead):
        self.parts, self.devices = parts, devices
        self.group_pages, self.lead = group_pages, lead

    def leaves(self):
        for row in self.parts:
            for part in row:
                yield from part.items()

    @property
    def names(self) -> tuple:
        return tuple(self.parts[0][0])

    def page_bytes(self) -> int:
        """One page's payload over every leaf and every kv head."""
        return sum(a.shape[0] * a[0, 0].numel() * a.element_size()
                   for part in self.parts[0] for a in part.values())

    def page_shapes(self) -> dict:
        """Each leaf's page payload shape ``[L, Hkv, page, (D)]``."""
        out = {}
        for name, a in self.parts[0][0].items():
            heads = sum(part[name].shape[2] for part in self.parts[0])
            out[name] = (a.shape[0], heads) + tuple(a.shape[3:])
        return out

    def page_template(self) -> dict:
        """One whole page of every leaf on the lead (``HostTier.reserve``
        takes its shapes, dtypes and device)."""
        return {name: torch.empty((shape[0], 1) + shape[1:],
                                  dtype=self.parts[0][0][name].dtype,
                                  device=self.lead)
                for name, shape in self.page_shapes().items()}

    def _by_group(self, pages: Sequence[int]):
        """(group, positions in ``pages``, local ids) for each group that
        ``pages`` names."""
        groups: Dict[int, list] = {}
        for i, p in enumerate(pages):
            groups.setdefault(int(p) // self.group_pages, []).append(i)
        for g, sel in groups.items():
            yield g, sel, [int(pages[i]) - g * self.group_pages for i in sel]

    def gather(self, pages: Sequence[int]) -> dict:
        """Queue a gather of whole pages (global ids) onto the lead:
        ``{name: [L, k, Hkv, page, (D)]}``, each a view of a contiguous
        ``[k, L, ...]`` buffer (``paged_kv.gather_pages``'s form)."""
        shapes = self.page_shapes()
        out = {name: torch.empty((len(pages),) + shape,
                                 dtype=self.parts[0][0][name].dtype,
                                 device=self.lead)
               for name, shape in shapes.items()}
        for g, sel, local in self._by_group(pages):
            dst = torch.tensor(sel, dtype=torch.int64, device=self.lead)
            for name in shapes:
                got = []
                for part, dev in zip(self.parts[g], self.devices[g]):
                    idx = torch.tensor(local, dtype=torch.int64, device=dev)
                    got.append(part[name].movedim(1, 0).index_select(0, idx)
                               .to(self.lead))
                out[name].index_copy_(0, dst, torch.cat(got, dim=2))
        return {name: buf.movedim(0, 1) for name, buf in out.items()}

    def restore(self, pages: Sequence[int], data: dict) -> None:
        """Write page payloads ``{name: [L, k, Hkv, page, (D)]}`` into the
        pages (global ids), in place, each shard taking its heads."""
        for g, sel, local in self._by_group(pages):
            for name in self.names:
                src = data[name][:, sel]
                h0 = 0
                for part, dev in zip(self.parts[g], self.devices[g]):
                    arr = part[name]
                    h = arr.shape[2]
                    idx = torch.tensor(local, dtype=torch.int64, device=dev)
                    arr.index_copy_(1, idx, src[:, :, h0:h0 + h]
                                    .to(device=dev, dtype=arr.dtype))
                    h0 += h


def tp_local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """``cfg`` at one tp shard's head counts (Hq / tp, Hkv / tp)."""
    return cfg.scaled(num_heads=cfg.num_heads // tp,
                      num_kv_heads=cfg.num_kv_heads // tp)


def init_pool_sharded(cfg: ModelConfig, group_pages: int, page_size: int,
                      dtype, mesh, quant: bool = False) -> ShardedPool:
    """The paged pool over the mesh's dp groups and tp shards: one zeroed
    ``paged_kv.init_pool`` of ``group_pages`` pages at Hkv / tp heads per
    (group, shard), allocated on its device (the ep, pp and sp index 0)."""
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv

    dp, tp = axis_size(mesh, "dp"), axis_size(mesh, "tp")
    local = tp_local_config(cfg, tp)
    devices = [[mesh.devices[g, 0, 0, 0, t] for t in range(tp)]
               for g in range(dp)]
    parts = [[pkv.init_pool(local, group_pages, page_size, dtype, dev,
                            quant=quant) for dev in row] for row in devices]
    return ShardedPool(parts, devices, group_pages, mesh.lead)


# -- the sequence-parallel dense cache ---------------------------------------


def init_cache_sharded(cfg: ModelConfig, num_slots: int, max_len: int,
                       dtype, mesh, quant: bool = False) -> List[dict]:
    """The dense cache of ``num_slots`` windows of ``max_len`` rows with its
    sequence axis split over the mesh's ``sp`` axis: shard i is a zeroed
    ``kv_cache.init_cache`` dict of ``max_len / sp`` rows on the i-th
    device of that axis, allocated there directly (never split from a
    whole cache)."""
    sp = sp_size(mesh)
    if max_len % sp:
        raise ValueError(f"cache window {max_len} does not split into "
                         f"sp={sp} sequence shards")
    return [kvc.init_cache(cfg, num_slots, max_len // sp, dtype, dev,
                           quant=quant) for dev in mesh.axis_devices("sp")]


def gather_rows(shards: List[dict], layer: int, slot: int, n: int,
                device) -> dict:
    """One slot's rows [0, n) of one layer, gathered from the shards in
    order onto ``device``: ``{"k", "v"}`` [Hkv, n, D] (and the scales
    ``{"ks", "vs"}`` [Hkv, n] of an int8 cache)."""
    parts = {name: [] for name in shards[0]}
    for shard, a, b, off in kvc.shard_spans(shards, 0, n):
        for name, leaf in shard.items():
            parts[name].append(leaf[layer, slot, :, a - off:b - off]
                               .to(device))
    return {name: torch.cat(p, dim=1) for name, p in parts.items()}
