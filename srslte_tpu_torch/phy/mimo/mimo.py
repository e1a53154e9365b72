"""Equalization (36.211 §6.3.3-4).

Reference behavior: lib/src/phy/mimo/precoding.c.  Ported so far: the
single-port (TM1) zero-forcing equalizer.  Transmit diversity (2 and 4
ports) and spatial multiplexing are ROADMAP queue A item 8.
"""

from __future__ import annotations

import torch


def equalize_zf(y, h):
    """Zero-forcing 1x1: x = y / h (precoding.c srsran_predecoding_single)."""
    return y * torch.conj(h) / torch.clamp(torch.abs(h) ** 2, min=1e-12)

