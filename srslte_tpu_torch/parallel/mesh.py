"""Device mesh construction for the sharded PHY.

The reference's parallelism axes (SURVEY.md §2.7) map onto named mesh axes:
per-carrier cc_workers -> "carrier" (data parallel), pipelined subframe
workers -> batched time blocks (a leading array axis, ordered by
construction rather than a tti_semaphore).

One controller drives every shard, as in the JAX package: a mesh is named
axes over a list of `torch.device`s, in which a device may repeat (eight
virtual shards of one card, or of the host, as the JAX tests use eight
virtual CPU devices); each shard is a tensor on its mesh device, and the
collectives of the sharded modules are explicit copies (`Mesh.shards`,
`Mesh.gather`).  The same code places shards on separate cards when the
mesh lists them.  The mesh carries no state beyond its device list, so
`convert.py` has nothing to carry for it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an ndarray of `torch.device`s."""

    devices: np.ndarray
    axis_names: tuple

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` (the first along every other axis):
        shard i of an array split over `axis` lives on the i-th."""
        k = self.axis_names.index(axis)
        index = tuple(slice(None) if i == k else 0 for i in range(self.devices.ndim))
        return list(self.devices[index])

    def shards(self, x, axis: str, dim: int = 0) -> list:
        """x split evenly along `dim` over the devices of `axis`, shard i
        copied to its device."""
        devs = self.axis_devices(axis)
        n = x.shape[dim]
        if n % len(devs):
            raise ValueError(f"dimension {dim} of length {n} does not split evenly "
                             f"over {len(devs)} shards")
        return [c.to(d) for c, d in zip(torch.chunk(x, len(devs), dim=dim), devs)]

    def gather(self, parts: list, axis: str, dim: int = 0) -> torch.Tensor:
        """The all-gather: every shard's part copied to the first device of
        `axis` and concatenated along `dim` in shard order."""
        dst = self.axis_devices(axis)[0]
        return torch.cat([p.to(dst) for p in parts], dim=dim)


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Build a Mesh with named axes, e.g. make_mesh({"carrier": 8}).

    axis_sizes values may use -1 once to absorb all remaining devices.
    `devices` defaults to every visible CUDA device, and a mesh is never
    built on the host unless the caller lists host devices (["cpu"] * 8).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch.cuda.is_available() is False; pass "
                               "devices=[...] explicitly to build a mesh on the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"need {total} devices, have {len(devices)}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(sizes), names)
