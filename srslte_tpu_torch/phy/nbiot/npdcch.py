"""NPDCCH + DCI formats N0/N1 (36.211 §10.2.5, 36.212 §6.4.3).

Reference behavior: lib/src/phy/phch/npdcch.c + dci_nbiot.c — 23-bit DCI,
CRC16 XOR RNTI, K=7 tail-biting convolutional code, QPSK; format 0 maps to
one NCCE (6 subcarriers), format 1 to both (the whole PRB); scrambling
c_init = (sf_idx << 9) + n_id (sequences.c srsran_sequence_npdcch:213).

The blind search decodes each (ncce, fmt) candidate with one Viterbi launch
[1, 39] and reads its CRC flag and bits back in one host read, in the
reference's order, until one passes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, sequence, table
from ..common.sequence import gold_sequence_signed
from ..fec.convolutional import conv_encode, rm_conv_rx, rm_conv_tx, viterbi_decode
from ..fec.crc import LTE_CRC16, crc_bits, crc_ok_device
from ..mimo import equalize_zf
from ..modem.modem import Modulation, demod_soft, modulate
from .npdsch import npdsch_re_indices

DCI_NB_LEN = 23


def _put(bits, pos, value, width):
    for i in range(width):
        bits[pos + i] = (int(value) >> (width - 1 - i)) & 1
    return pos + width


def _get(bits, pos, width):
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i])
    return v, pos + width


@dataclass(frozen=True)
class DciN1:
    """DL grant (36.212 table 6.4.3.2-1, 23 bits)."""

    i_delay: int = 0  # scheduling delay, 3 bits
    i_sf: int = 0  # resource assignment, 3 bits
    i_mcs: int = 0  # 4 bits (equals I_TBS for standalone)
    i_rep: int = 0  # repetition number, 4 bits
    ndi: int = 0
    harq_ack: int = 0  # HARQ-ACK resource, 4 bits
    dci_rep: int = 0  # DCI subframe repetition, 2 bits
    order_ind: int = 0  # NPDCCH order indicator


def pack_dci_n1(d: DciN1) -> np.ndarray:
    bits = np.zeros(DCI_NB_LEN, np.uint8)
    pos = _put(bits, 0, 1, 1)  # flag: 1 = N1
    pos = _put(bits, pos, d.order_ind, 1)
    pos = _put(bits, pos, d.i_delay, 3)
    pos = _put(bits, pos, d.i_sf, 3)
    pos = _put(bits, pos, d.i_mcs, 4)
    pos = _put(bits, pos, d.i_rep, 4)
    pos = _put(bits, pos, d.ndi, 1)
    pos = _put(bits, pos, d.harq_ack, 4)
    _put(bits, pos, d.dci_rep, 2)
    return bits


def unpack_dci_n1(bits: np.ndarray) -> DciN1 | None:
    pos = 0
    flag, pos = _get(bits, pos, 1)
    if flag != 1:
        return None
    order, pos = _get(bits, pos, 1)
    i_delay, pos = _get(bits, pos, 3)
    i_sf, pos = _get(bits, pos, 3)
    i_mcs, pos = _get(bits, pos, 4)
    i_rep, pos = _get(bits, pos, 4)
    ndi, pos = _get(bits, pos, 1)
    harq_ack, pos = _get(bits, pos, 4)
    dci_rep, pos = _get(bits, pos, 2)
    return DciN1(i_delay, i_sf, i_mcs, i_rep, ndi, harq_ack, dci_rep, order)


@dataclass(frozen=True)
class DciN0:
    """UL grant (36.212 table 6.4.3.1-1, 23 bits)."""

    sc_ind: int = 0  # subcarrier indication, 6 bits
    i_ru: int = 0  # resource assignment, 3 bits
    i_delay: int = 0  # scheduling delay, 2 bits
    i_mcs: int = 0  # 4 bits
    rv: int = 0  # redundancy version, 1 bit
    i_rep: int = 0  # repetition number, 3 bits
    ndi: int = 0
    dci_rep: int = 0  # 2 bits


def pack_dci_n0(d: DciN0) -> np.ndarray:
    bits = np.zeros(DCI_NB_LEN, np.uint8)
    pos = _put(bits, 0, 0, 1)  # flag: 0 = N0
    pos = _put(bits, pos, d.sc_ind, 6)
    pos = _put(bits, pos, d.i_ru, 3)
    pos = _put(bits, pos, d.i_delay, 2)
    pos = _put(bits, pos, d.i_mcs, 4)
    pos = _put(bits, pos, d.rv, 1)
    pos = _put(bits, pos, d.i_rep, 3)
    pos = _put(bits, pos, d.ndi, 1)
    _put(bits, pos, d.dci_rep, 2)
    return bits


def unpack_dci_n0(bits: np.ndarray) -> DciN0 | None:
    pos = 0
    flag, pos = _get(bits, pos, 1)
    if flag != 0:
        return None
    sc, pos = _get(bits, pos, 6)
    i_ru, pos = _get(bits, pos, 3)
    i_delay, pos = _get(bits, pos, 2)
    i_mcs, pos = _get(bits, pos, 4)
    rv, pos = _get(bits, pos, 1)
    i_rep, pos = _get(bits, pos, 3)
    ndi, pos = _get(bits, pos, 1)
    dci_rep, pos = _get(bits, pos, 2)
    return DciN0(sc, i_ru, i_delay, i_mcs, rv, i_rep, ndi, dci_rep)


@dataclass(frozen=True)
class Npdcch:
    """NPDCCH processor for one (n_id, sf_idx); standalone 1 PRB."""

    n_id: int
    sf_idx: int
    nof_ports: int = 1
    l_start: int = 0

    @functools.cached_property
    def _all_re(self) -> np.ndarray:
        return npdsch_re_indices(self.n_id, self.nof_ports, self.l_start)

    def re_idx(self, ncce: int, fmt: int) -> np.ndarray:
        """Format 1: both NCCEs (all REs); format 0: NCCE = 6-SC half."""
        if fmt == 1:
            return self._all_re
        sel = self._all_re % 12
        lo, hi = (0, 6) if ncce == 0 else (6, 12)
        return self._all_re[(sel >= lo) & (sel < hi)]

    def _scramble_signed(self, e: int) -> np.ndarray:
        cinit = ((self.sf_idx << 9) + self.n_id) % (1 << 31)
        return gold_sequence_signed(cinit, e)

    def _tables(self, ncce: int, fmt: int, device):
        """(RE indices, signed scrambling of the candidate's share of the
        full-PRB sequence) on the device."""
        key = ("npdcch", self.n_id, self.sf_idx, self.nof_ports, self.l_start, ncce, fmt)
        idx_np = self.re_idx(ncce, fmt)
        e = 2 * len(idx_np)
        off = 0 if (fmt == 1 or ncce == 0) else e  # format 0: the NCCE's share
        idx = table(key + ("re",), device, lambda: idx_np.astype(np.int64))
        scr = table(key + ("scr",), device, lambda: self._scramble_signed(
            2 * len(self._all_re))[off : off + e])
        return idx, scr

    def encode(self, grids, payload: np.ndarray, rnti: int, ncce: int = 0,
               fmt: int = 1, device=None):
        grids = as_tensor(grids, device)
        dev = grids.device
        crc = crc_bits(np.asarray(payload, np.uint8), *LTE_CRC16)
        crc ^= np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.uint8)
        msg = as_tensor(np.concatenate([payload, crc]).astype(np.uint8), dev)
        idx, scr = self._tables(ncce, fmt, dev)
        coded = rm_conv_tx(conv_encode(msg, DCI_NB_LEN + 16), len(scr))
        sym = modulate(coded ^ (scr < 0).to(torch.uint8), Modulation.QPSK)
        flat = grids.reshape(grids.shape[:-2] + (-1,)).clone()
        flat[..., 0, idx] = sym
        return flat.reshape(grids.shape)

    def search(self, grid, ce, rnti: int,
               candidates: tuple = ((0, 1), (0, 0), (1, 0)), device=None):
        """Blind search over (ncce, fmt) candidates -> (loc, DciN0/N1)."""
        grid = as_tensor(grid, device)
        ce = as_tensor(ce, grid.device)
        mask = sequence(("rnti_mask", rnti), grid.device, lambda: np.array(
            [(rnti >> (15 - i)) & 1 for i in range(16)], np.uint8))
        for ncce, fmt in candidates:
            idx, scr = self._tables(ncce, fmt, grid.device)
            y = grid.reshape(-1)[idx]
            h = ce[0].reshape(-1)[idx]
            xhat = equalize_zf(y, h)
            llr = demod_soft(xhat, Modulation.QPSK) * scr
            de_rm = rm_conv_rx(llr, 3 * (DCI_NB_LEN + 16))
            bits = viterbi_decode(de_rm[None], DCI_NB_LEN + 16)[0]
            ok = crc_ok_device(bits, *LTE_CRC16, rnti_mask=mask)
            host = torch.cat([ok.reshape(1).to(torch.uint8), bits]).cpu().numpy()
            if host[0]:
                payload = host[1 : 1 + DCI_NB_LEN]
                dci = unpack_dci_n1(payload) or unpack_dci_n0(payload)
                return (ncce, fmt), dci
        return None
