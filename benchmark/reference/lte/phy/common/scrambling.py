# Frozen copy of srslte_tpu_torch/phy/common/scrambling.py at commit e4337f4, unchanged but for this line.
"""Gold-sequence scrambling of bits and LLRs (36.211 §6.3.1/§7.2).

Reference behavior: lib/src/phy/scrambling/scrambling.c: bits are XORed with
c(n); soft values (LLRs) are sign-flipped where c(n)=1.  Seeds for each
channel follow 36.211 (e.g. PDSCH: c_init = rnti*2^14 + q*2^13 + floor(ns/2)*2^9
+ N_cell_id, pdsch.c; PBCH: c_init = N_cell_id).
"""

from __future__ import annotations

import torch

from ..._device import as_tensor, sequence
from .sequence import gold_sequence, gold_sequence_signed


def scramble_bits(bits, seed: int, device=None):
    """XOR bits [..., n] with c(0..n-1) (host-precomputed table)."""
    bits = as_tensor(bits, device)
    n = bits.shape[-1]
    # the PDSCH, PUSCH and PUCCH seeds carry the RNTI: a per-UE table
    c = sequence(("gold", seed, n), bits.device, lambda: gold_sequence(seed, n))
    return (bits.to(torch.uint8) ^ c).to(bits.dtype)


def scramble_llr(llr, seed: int, device=None):
    """Flip LLR signs where c(n)=1 (descrambling of soft bits)."""
    llr = as_tensor(llr, device)
    n = llr.shape[-1]
    s = sequence(("gold_signed", seed, n), llr.device,
                 lambda: gold_sequence_signed(seed, n))
    return llr * s


def pdsch_cinit(rnti: int, q: int, sf_idx: int, cell_id: int) -> int:
    """36.211 §6.3.1 PDSCH scrambling seed (pdsch.c srsran_sequence_pdsch)."""
    return (rnti << 14) + (q << 13) + ((sf_idx % 10) << 9) + cell_id


def pbch_cinit(cell_id: int) -> int:
    return cell_id


def pcfich_cinit(sf_idx: int, cell_id: int) -> int:
    """36.211 §6.7.1: c_init = (ns/2+1)*(2*NID+1)*2^9 + NID."""
    return ((sf_idx % 10) + 1) * (2 * cell_id + 1) * 512 + cell_id


def pdcch_cinit(sf_idx: int, cell_id: int) -> int:
    """36.211 §6.8.2: c_init = ns/2 * 2^9 + NID."""
    return ((sf_idx % 10) << 9) + cell_id


def pusch_cinit(rnti: int, sf_idx: int, cell_id: int) -> int:
    return (rnti << 14) + ((sf_idx % 10) << 9) + cell_id
