"""NPDSCH: narrowband downlink shared channel (36.211 §10.2.3, npdsch.c).

Reference behavior: lib/src/phy/phch/npdsch.c + ra_nbiot.c — CRC24A,
K=7 tail-biting convolutional code (NB-IoT has no turbo), QPSK only, the
codeword spans `nof_sf` subframes with per-subframe scrambling
c_init = (rnti << 14) + ((nf % 2) << 13) + (sf_idx << 9) + n_id
(sequences.c srsran_sequence_npdsch:204); TBS from the 36.213 table
16.4.1.5.1-1 (tbs_tables_nbiot.h).  Standalone deployment: the PRB carries
only NRS, l_start = 0.

The decoder equalizes and demodulates all subframes of the codeword as one
batch and runs one tail-biting Viterbi candidate of tbs + 24 bits (up to
704) through `fec.convolutional.viterbi_decode`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, sequence, table
from ..common.sequence import gold_sequence_signed
from ..fec.convolutional import conv_encode, rm_conv_rx, rm_conv_tx, viterbi_decode
from ..fec.crc import LTE_CRC24A, crc_calc, crc_ok_device
from ..mimo import alamouti_decode_2tx, alamouti_encode_2tx, equalize_zf
from ..modem.modem import Modulation, demod_soft, modulate
from .nrs import nrs_reserved_sc

# 36.213 table 16.4.1.3-1: I_SF -> number of subframes
NOF_SF_TABLE = (1, 2, 3, 4, 5, 6, 8, 10)

# 36.213 table 16.4.1.5.1-1 (R13 cap at 680; tbs_tables_nbiot.h)
TBS_TABLE_NB = (
    (16, 32, 56, 88, 120, 152, 208, 256),
    (24, 56, 88, 144, 176, 208, 256, 344),
    (32, 72, 144, 176, 208, 256, 328, 424),
    (40, 104, 176, 208, 256, 328, 440, 568),
    (56, 120, 208, 256, 328, 408, 552, 680),
    (72, 144, 224, 328, 424, 504, 680, 0),
    (88, 176, 256, 392, 504, 600, 0, 0),
    (104, 224, 328, 472, 584, 680, 0, 0),
    (120, 256, 392, 536, 680, 0, 0, 0),
    (136, 296, 456, 616, 0, 0, 0, 0),
    (144, 328, 504, 680, 0, 0, 0, 0),
    (176, 376, 584, 0, 0, 0, 0, 0),
    (208, 440, 680, 0, 0, 0, 0, 0),
)


@dataclass(frozen=True)
class NbDlGrant:
    """NPDSCH allocation (single PRB, whole-band by definition)."""

    i_tbs: int
    i_sf: int
    l_start: int = 0  # 0 standalone / guard band; 3 in-band

    @property
    def nof_sf(self) -> int:
        return NOF_SF_TABLE[self.i_sf]

    @property
    def tbs(self) -> int:
        tbs = TBS_TABLE_NB[self.i_tbs][self.i_sf]
        if tbs == 0:
            raise ValueError(f"invalid (I_TBS={self.i_tbs}, I_SF={self.i_sf})")
        return tbs


@functools.lru_cache(maxsize=None)
def npdsch_re_indices(n_id: int, nof_ports: int, l_start: int = 0) -> np.ndarray:
    """Flat 1-PRB subframe-grid data RE indices (NRS punctured)."""
    res = nrs_reserved_sc(n_id, nof_ports)
    idx = []
    for l in range(l_start, 14):
        ks = np.arange(12)
        if l in res:
            ks = ks[[k not in res[l] for k in ks]]
        idx.append(l * 12 + ks)
    return np.concatenate(idx).astype(np.int32)


@dataclass(frozen=True)
class Npdsch:
    """NPDSCH processor for one (n_id, grant, rnti)."""

    n_id: int
    grant: NbDlGrant
    rnti: int
    nof_ports: int = 1

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        return npdsch_re_indices(self.n_id, self.nof_ports,
                                 self.grant.l_start)

    @property
    def nof_re(self) -> int:
        return len(self.re_idx)

    @property
    def G(self) -> int:
        return 2 * self.nof_re * self.grant.nof_sf

    def _re_idx_t(self, device) -> torch.Tensor:
        return table(("npdsch_re", self.n_id, self.nof_ports, self.grant.l_start), device,
                     lambda: self.re_idx.astype(np.int64))

    def _cinit(self, sf_idx: int, nf: int) -> int:
        return ((self.rnti << 14) + ((nf % 2) << 13) + (sf_idx << 9)
                + self.n_id) % (1 << 31)

    def _scramble_signed(self, sf_idx: int, nf: int) -> np.ndarray:
        return gold_sequence_signed(self._cinit(sf_idx, nf), 2 * self.nof_re)

    def _scrambling(self, sf_nf: tuple, device) -> torch.Tensor:
        """[nof_sf, 2 nof_re] signed scrambling of the codeword's subframes
        (it carries the RNTI: a `sequence`, not a `table`)."""
        seeds = tuple(self._cinit(s, nf) for s, nf in sf_nf)
        return sequence(("npdsch_scr", seeds, 2 * self.nof_re), device,
                        lambda: np.stack([self._scramble_signed(s, nf) for s, nf in sf_nf]))

    def encode(self, bits, grids_sf, sf_nf: tuple, device=None):
        """bits [tbs] -> list of per-subframe grids.

        grids_sf: [nof_sf, nports, 14, 12]; sf_nf: tuple of (sf_idx, nf)
        per subframe (scrambling re-initializes every subframe).
        """
        bits = as_tensor(bits, device).to(torch.uint8)
        dev = bits.device
        crc = crc_calc(bits, *LTE_CRC24A).to(torch.uint8)
        msg = torch.cat([bits, crc])
        k = self.grant.tbs + 24
        coded = rm_conv_tx(conv_encode(msg, k), self.G)
        idx = self._re_idx_t(dev)
        s = (self._scrambling(sf_nf, dev) < 0).to(torch.uint8)
        sym = modulate(coded.reshape(len(sf_nf), -1) ^ s, Modulation.QPSK)  # [nof_sf, nof_re]
        if self.nof_ports == 2:
            tx = alamouti_encode_2tx(sym)
        out = []
        for i in range(len(sf_nf)):
            g = as_tensor(grids_sf[i], dev)
            flat = g.reshape(g.shape[:-2] + (-1,)).clone()
            if self.nof_ports == 1:
                flat[..., 0, idx] = sym[i]
            else:
                flat[..., 0, idx] = tx[i, 0]
                flat[..., 1, idx] = tx[i, 1]
            out.append(flat.reshape(g.shape))
        return out

    def decode(self, grids_rx, ces, sf_nf: tuple, device=None):
        """grids_rx [nof_sf, 14, 12], ces [nof_sf, nports, 14, 12]
        -> (bits [tbs], crc_ok)."""
        grids_rx = as_tensor(grids_rx, device)
        ces = as_tensor(ces, grids_rx.device)
        nsf = len(sf_nf)
        idx = self._re_idx_t(grids_rx.device)
        y = grids_rx.reshape(nsf, -1)[:, idx]
        h = ces.reshape(nsf, ces.shape[1], -1)[:, :, idx]
        if self.nof_ports == 1:
            xhat = equalize_zf(y, h[:, 0])
        else:
            xhat = alamouti_decode_2tx(y, h[:, 0], h[:, 1])
        llr = demod_soft(xhat, Modulation.QPSK) * self._scrambling(sf_nf, y.device)
        full = llr.reshape(-1)
        k = self.grant.tbs + 24
        de_rm = rm_conv_rx(full, 3 * k)
        bits = viterbi_decode(de_rm[None], k)[0]
        ok = crc_ok_device(bits, *LTE_CRC24A)
        return bits[..., : self.grant.tbs], ok
