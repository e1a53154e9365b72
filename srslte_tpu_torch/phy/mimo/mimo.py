"""Equalization and transmit diversity (36.211 §6.3.3-4).

Reference behavior: lib/src/phy/mimo/precoding.c.  Ported so far: the
single-port (TM1) zero-forcing equalizer and 2-port SFBC transmit diversity
(PBCH) per 36.211 §6.3.4.3:

    port0: [ x0,  x1 ]      port1: [ -x1*, x0* ]   (pairs of subcarriers,
    with 1/sqrt(2) scaling at the transmitter)

Everything is elementwise over RE pairs and batched.  4-port transmit
diversity and spatial multiplexing are ROADMAP queue A item 8.
"""

from __future__ import annotations

import math

import torch


def equalize_zf(y, h):
    """Zero-forcing 1x1: x = y / h (precoding.c srsran_predecoding_single)."""
    return y * torch.conj(h) / torch.clamp(torch.abs(h) ** 2, min=1e-12)


def alamouti_encode_2tx(x):
    """SFBC: x [..., n] (n even) -> per-port symbols [..., 2, n].

    36.211 §6.3.4.3 with the C library's pairing over adjacent REs
    (precoding.c srsran_precoding_diversity, 2 ports).
    """
    x0, x1 = x[..., 0::2], x[..., 1::2]
    p0 = torch.stack([x0, x1], dim=-1).reshape(x.shape)
    p1 = torch.stack([-torch.conj(x1), torch.conj(x0)], dim=-1).reshape(x.shape)
    return torch.stack([p0, p1], dim=-2) / math.sqrt(2.0)


def alamouti_decode_2tx(y, h0, h1, noise_var=0.0):
    """SFBC combine: y [..., n], per-port channels h0/h1 [..., n] -> x [..., n].

    Alamouti combining over RE pairs (precoding.c
    srsran_predecoding_diversity), the channel of each pair member taken as
    its own estimate:
      y_a = (h0 x0 - h1 x1*)/sqrt2 ; y_b = (h0 x1 + h1 x0*)/sqrt2
      x0 = sqrt2 (h0a* y_a + h1b y_b*) / (|h0|^2+|h1|^2)
      x1 = sqrt2 (h0b* y_b - h1a y_a*) / (|h0|^2+|h1|^2)
    """
    ya, yb = y[..., 0::2], y[..., 1::2]
    h0a, h0b = h0[..., 0::2], h0[..., 1::2]
    h1a, h1b = h1[..., 0::2], h1[..., 1::2]
    denom = (torch.abs(h0a) ** 2 + torch.abs(h1a) ** 2) / 2 \
        + (torch.abs(h0b) ** 2 + torch.abs(h1b) ** 2) / 2 + noise_var
    denom = torch.clamp(denom, min=1e-12)
    x0 = (torch.conj(h0a) * ya + h1b * torch.conj(yb)) / denom
    x1 = (torch.conj(h0b) * yb - h1a * torch.conj(ya)) / denom
    out = torch.stack([x0, x1], dim=-1).reshape(y.shape)
    return out * math.sqrt(2.0)
