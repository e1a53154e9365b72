"""The card's peak and the least time of a kernel's work.

The HBM rate is NVIDIA's H100 SXM data sheet figure, at the 700 W power
limit.
"""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12

_SISO_KEY = re.compile(r"B=(\d+) K=(\d+) L=(\d+) T=(\d+)")


def siso_bytes(batch: int, k: int, dtype_bytes: int) -> int:
    """Bytes one `siso_windowed` launch must move: each input read once
    (the systematic-plus-a-priori and the parity LLRs [B, K], the tail's
    beta [B, 8]) and the output [B, K] written once, at the call's dtype.
    The interleaver (int32 [K], on half the launches) is left out: it is
    under 0.03 % of the bytes at the path's shapes, and a count that is too
    low can only lower the share."""
    return (3 * batch * k + 8 * batch) * dtype_bytes


def siso_least_s(shapes) -> float:
    """The least time of the launches `shapes` counts ({(kernel, "B=.. K=..
    L=.. T=.."): launches}), bound by bytes at the HBM's rate."""
    total = 0.0
    for (kernel, key), n in shapes.items():
        m = _SISO_KEY.fullmatch(key)
        if m is None:
            raise ValueError(f"unreadable SISO shape {key!r}")
        b, k = int(m.group(1)), int(m.group(2))
        total += n * siso_bytes(b, k, 2 if kernel.endswith("bf16") else 4) / HBM_BYTES_PER_S
    return total
