"""Overlap-save halo exchange over the mesh (SURVEY.md §5.7).

The reference keeps streaming windows with overlap so PSS correlation can
span buffer boundaries (ue_sync.c:697-724).  Sharded over devices, the same
pattern becomes: split the stream into per-device time chunks, fetch the head
of the RIGHT neighbour's chunk (a copy from its device: the JAX package's
`ppermute`), correlate locally, then pick the winner among every shard's
(gathered on the first device: its `all_gather`).
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..phy.sync.pss import pss_find


def halo_extend(shards: list, halo: int) -> list:
    """Extend each shard [..., L] with the next shard's head [..., halo],
    copied to its device.  The last shard wraps to shard 0 (callers mask or
    size the stream so the wrap region is padding)."""
    n = len(shards)
    return [torch.cat([x, shards[(i + 1) % n][..., :halo].to(x.device)], dim=-1)
            for i, x in enumerate(shards)]


def sharded_pss_search(samples, fft_size: int, mesh, axis: str = "t"):
    """PSS search over a stream sharded across mesh axis `axis`.

    samples: [N] complex64, N divisible by the axis size.  Each shard
    searches its chunk (+halo) for all 3 N_id_2; a final argmax over the
    gathered per-shard peaks gives the global (n_id_2, offset, metric),
    0-d tensors on the first shard's device — identical to the unsharded
    pss_find_peak over the full stream, except within `fft_size` of the very
    end (wrap region).
    """
    devs = mesh.axis_devices(axis)
    x = as_tensor(samples, devs[0]).to(torch.complex64)
    shards = mesh.shards(x, axis)
    chunk = shards[0].shape[-1]
    winners = []
    for ext in halo_extend(shards, fft_size):  # the halo covers a window across the boundary
        p = pss_find(ext, fft_size)  # [3, chunk + 1] local correlation
        flat = p.reshape(-1)
        am = torch.argmax(flat)
        nvalid = p.shape[-1]
        winners.append(torch.stack([flat[am].to(torch.float64),
                                    torch.div(am, nvalid, rounding_mode="floor").to(torch.float64),
                                    (am % nvalid).to(torch.float64)]))
    won = mesh.gather([w[None] for w in winners], axis)  # [n, (metric, n_id_2, offset)]
    win = torch.argmax(won[:, 0])
    metric, n_id_2, off = won[win]
    return (n_id_2.to(torch.int32), (win * chunk + off.to(torch.int64)).to(torch.int32),
            metric.to(torch.float32))
