"""NPBCH: narrowband broadcast channel (36.211 §10.2.4, npbch.c).

Reference behavior: lib/src/phy/phch/npbch.c — MIB-NB (34 bits) + CRC16
masked by the antenna-port pattern (srsran_npbch_crc_mask), K=7 tail-biting
convolutional code, rate-matched to 1600 bits, split into 8 blocks of 200
bits, each block repeated in 8 consecutive frames (64-frame period),
scrambling c_init = n_id_ncell reset at nf mod 64 == 0, QPSK, mapped to
subframe-0 symbols 3-13 skipping 4 REs in every symbol that carries NRS or
(assumed 4-port) LTE CRS — 100 data REs (SRSRAN_NPBCH_NUM_RE).

Like pbch.py, all 16 (block-phase x port) hypotheses decode as one
Viterbi launch [16, 50] and one CRC product, read back in one host read.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table, take
from ...utils.jit import lazy_jit
from ..common.sequence import gold_sequence, gold_sequence_signed
from ..fec.convolutional import conv_encode_np, rm_conv_indices, rm_conv_rx, viterbi_decode
from ..fec.crc import LTE_CRC16, crc_bits, crc_calc
from ..mimo import alamouti_decode_2tx, alamouti_encode_2tx, equalize_zf
from ..modem.modem import Modulation, demod_soft, modulate
from .nrs import NRS_SYMBOLS

MIB_NB_LEN = 34
PAYLOAD = MIB_NB_LEN + 16
E_TOTAL = 1600  # 8 blocks x 100 RE x 2 bits
E_BLOCK = 200
NPBCH_SYMBOLS = tuple(range(3, 14))
_CRS_SYMBOLS = (4, 7, 8, 11)  # assumed LTE CRS symbols within 3..13


def crc_mask_nb(nof_ports: int) -> np.ndarray:
    """36.212 table 5.3.1.1-1 for NPBCH (npbch.c srsran_npbch_crc_mask)."""
    if nof_ports == 1:
        return np.zeros(16, np.uint8)
    return np.ones(16, np.uint8)


@dataclass(frozen=True)
class MibNb:
    """MIB-NB essentials (36.331 MasterInformationBlock-NB)."""

    sfn_msb: int = 0  # 4 MSBs of the SFN
    hyper_sfn_lsb: int = 0  # 2 LSBs of the hyper SFN
    sched_info_sib1: int = 0  # 4 bits
    sys_info_tag: int = 0  # 5 bits
    ab_enabled: int = 0  # access barring, 1 bit
    op_mode: int = 0  # 7 bits operationModeInfo
    spare: int = 0  # 11 bits

    def pack(self) -> np.ndarray:
        bits = np.zeros(MIB_NB_LEN, np.uint8)
        pos = 0
        for val, width in ((self.sfn_msb, 4), (self.hyper_sfn_lsb, 2),
                           (self.sched_info_sib1, 4), (self.sys_info_tag, 5),
                           (self.ab_enabled, 1), (self.op_mode, 7),
                           (self.spare, 11)):
            for i in range(width):
                bits[pos + i] = (val >> (width - 1 - i)) & 1
            pos += width
        return bits

    @staticmethod
    def unpack(bits: np.ndarray) -> "MibNb":
        vals = []
        pos = 0
        for width in (4, 2, 4, 5, 1, 7, 11):
            v = 0
            for i in range(width):
                v = (v << 1) | int(bits[pos + i])
            vals.append(v)
            pos += width
        return MibNb(*vals)


@functools.lru_cache(maxsize=None)
def npbch_re_indices(n_id: int, n_prb_grid: int = 1) -> np.ndarray:
    """Flat subframe-grid indices of the 100 NPBCH REs (1-PRB grid)."""
    nre = 12 * n_prb_grid
    rs_sc = {(v + n_id % 6) % 6 + 6 * m for v in (0, 3) for m in (0, 1)}
    idx = []
    for l in NPBCH_SYMBOLS:
        ks = np.arange(12)
        if l in _CRS_SYMBOLS or l in NRS_SYMBOLS:
            ks = ks[[k not in rs_sc for k in ks]]
        idx.append(l * nre + ks)
    out = np.concatenate(idx).astype(np.int32)
    assert len(out) == 100
    return out


@dataclass(frozen=True)
class Npbch:
    """NPBCH processor (standalone deployment, 1-PRB grid)."""

    n_id: int
    nof_ports: int = 1

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        return npbch_re_indices(self.n_id)

    def _re_idx_t(self, device) -> torch.Tensor:
        return table(("npbch_re", self.n_id), device, lambda: self.re_idx.astype(np.int64))

    @functools.lru_cache(maxsize=None)
    def _codeword(self, mib: MibNb) -> np.ndarray:
        """Scrambled 1600-bit codeword for one 64-frame period."""
        msg = mib.pack()
        crc = crc_bits(msg, *LTE_CRC16) ^ crc_mask_nb(self.nof_ports)
        payload = np.concatenate([msg, crc])
        coded = conv_encode_np(payload)[rm_conv_indices(3 * PAYLOAD, E_TOTAL)]
        return coded ^ gold_sequence(self.n_id, E_TOTAL)

    def encode_frame(self, mib: MibNb, nf: int, grids, device=None):
        """Write frame nf's repetition block into subframe-0 grids."""
        grids = as_tensor(grids, device)
        block = (nf % 64) // 8
        scr = self._codeword(mib)
        quarter = as_tensor(scr[E_BLOCK * block : E_BLOCK * (block + 1)], grids.device)
        sym = modulate(quarter, Modulation.QPSK)  # [100]
        idx = self._re_idx_t(grids.device)
        flat = grids.reshape(grids.shape[:-2] + (-1,)).clone()
        if self.nof_ports == 1:
            flat[..., 0, idx] = sym
        else:
            tx = alamouti_encode_2tx(sym)
            flat[..., 0, idx] = tx[0]
            flat[..., 1, idx] = tx[1]
        return flat.reshape(grids.shape)

    def decode(self, grid, ce, device=None):
        """Single-frame blind decode over (block, ports) hypotheses.

        grid [nsym, nre], ce [2, nsym, nre] -> (ok, mib, block) with block
        the recovered frame phase nf mod 64 // 8.
        """
        ok, bits, win = self._decode_dev(as_tensor(grid, device), as_tensor(ce, device))
        host = torch.cat([ok.reshape(1).to(torch.uint8), win.reshape(1).to(torch.uint8),
                          bits]).cpu().numpy()
        return bool(host[0]), MibNb.unpack(host[2 : 2 + MIB_NB_LEN]), int(host[1]) % 8

    @lazy_jit(static_argnums=(0,))
    def _decode_dev(self, grid, ce):
        dev = grid.device
        idx = self._re_idx_t(dev)
        y = grid.reshape(-1)[idx]
        h0 = ce[0].reshape(-1)[idx]
        h1 = ce[1].reshape(-1)[idx]
        x1 = equalize_zf(y, h0)
        x2 = alamouti_decode_2tx(y, h0, h1)
        llr_hyp = torch.stack([demod_soft(x1, Modulation.QPSK),
                               demod_soft(x2, Modulation.QPSK)])  # [2, 200]
        s = table(("npbch_scr", self.n_id), dev,
                  lambda: gold_sequence_signed(self.n_id, E_TOTAL))
        # hypothesis (ports, b) holds the received block at block b's place
        # of the 1600-bit codeword and zeros elsewhere: one scatter
        buf = llr_hyp.new_zeros((2, 8, 8, E_BLOCK))
        b = torch.arange(8, device=dev)
        buf[:, b, b] = llr_hyp[:, None, :].expand(2, 8, E_BLOCK)
        buf = (buf.reshape(2, 8, E_TOTAL) * s).reshape(16, E_TOTAL)
        de_rm = rm_conv_rx(buf, 3 * PAYLOAD)
        bits = viterbi_decode(de_rm, PAYLOAD)  # [16, 50]
        calc = crc_calc(bits[:, :MIB_NB_LEN], *LTE_CRC16).to(torch.int32)
        rx = bits[:, MIB_NB_LEN:].to(torch.int32)
        masks = table("npbch_crc_masks", dev,
                      lambda: np.stack([crc_mask_nb(1), crc_mask_nb(2)]).astype(np.int32))
        ok = torch.all(calc == (rx ^ masks[torch.arange(16, device=dev) // 8]), dim=-1)
        win = torch.argmax(ok.to(torch.int32))
        return torch.any(ok), take(bits, win), win
