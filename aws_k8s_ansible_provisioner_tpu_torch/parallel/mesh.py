"""The serving mesh: named axes over the devices one process drives.

The JAX package builds a ``jax.sharding.Mesh`` (its ``parallel/mesh.py``:
``make_mesh`` `:28-54`, ``auto_mesh_config`` `:57-72`) and one process
drives every device through ``shard_map``. The port keeps that
single-controller shape: a :class:`Mesh` is a numpy array of
``torch.device`` with the axis names of ``config.MeshConfig``, and the
engine runs each shard's kernels on its device from the one process. No
``torch.distributed`` is involved: the sequence-parallel decode moves each
shard's ``[B, Hq]`` and ``[B, Hq, D]`` partials to the lead device and
merges them there (``ops/attention.make_decode_attend_carry``); the dp,
tp and ep axes run ``models/layers.MeshLM``, whose partial sums and
vocabulary slices move by the explicit copies of
``parallel/collectives.py``. ``pp`` is not served (the pipeline schedule
is training-only).

Without a device list a mesh takes the visible CUDA cards, one per mesh
position, and raises when there are fewer than it needs. An explicit list
may repeat a device: ``[torch.device("cpu")] * sp`` runs the shards on the
CPU (the tests), ``[torch.device("cuda:0")] * sp`` runs them on one card
(the smoke test).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from aws_k8s_ansible_provisioner_tpu_torch.config import MeshConfig


class Mesh:
    """Named axes over a numpy array of ``torch.device``.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does; ``devices`` is the array, one axis per name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-axis device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def lead(self) -> torch.device:
        """The device that holds the parameters and merges the partials."""
        return self.devices.flat[0]

    def axis_devices(self, name: str) -> list:
        """The devices along axis ``name``, every other axis at index 0:
        shard i of that axis lives on the i-th."""
        ax = self.axis_names.index(name)
        index = [0] * self.devices.ndim
        index[ax] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(mesh_cfg: MeshConfig,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, pp, sp, ep, tp) mesh over ``devices`` (default: every visible
    CUDA card), laid out in ``MeshConfig.axis_names`` order as the JAX
    package lays it out. Raises when there are fewer devices than the mesh
    needs."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [torch.device(d) for d in devices]
    n = mesh_cfg.num_devices
    if len(devices) < n:
        raise ValueError(
            f"mesh {mesh_cfg} needs {n} devices, have {len(devices)}")
    names = mesh_cfg.axis_names
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape([getattr(mesh_cfg, a) for a in names]), names)


def auto_mesh_config(n_devices: int, want_sp: bool = True,
                     max_tp: int = 8) -> MeshConfig:
    """Factor a device count into a (dp, tp, sp) MeshConfig: tp up to
    ``max_tp`` first, then sp 2 when asked for and divisible, the rest to
    dp (the JAX package's rule)."""
    tp = 1
    rem = n_devices
    for cand in (8, 4, 2):
        if cand <= max_tp and rem % cand == 0:
            tp = cand
            rem //= cand
            break
    sp = 1
    if want_sp and rem % 2 == 0:
        sp = 2
        rem //= 2
    return MeshConfig(dp=rem, tp=tp, sp=sp)
