"""Sidelink channels PSBCH / PSCCH / PSSCH, TM1/2 normal CP (36.211 §9).

Reference behavior: lib/src/phy/phch/psbch.c (encode:195 — CRC16, K=7 TBCC,
rate match, PUSCH-style channel interleaver, N_sl_id scrambling, QPSK, DFT
precoding, 7-of-8-symbol mapping), pscch.c (SCI + CRC16, seed-510
scrambling, 1 PRB), pssch.c (turbo DL-SCH-style coding with
c_init = N_x_id*2^14 + (sf mod 10)*2^9 + 510), sci.c (SCI format 0 codec).

Each channel's geometry (grid indices, interleaver, DMRS, scrambling) is a
host table uploaded once per device; encode and decode are a handful of
batched tensor operations on the grid's device, with the convolutional and
turbo codecs of the LTE uplink.  PSBCH and PSCCH decode one grid at a time
(a [1, 3K] Viterbi launch and one host read of the CRC flag and the bits);
`Pssch.decode` takes a batch of grids [B, 14, n_prb*12] and decodes every
code block of the batch in one turbo cascade.  The tables are built here
from the same host code as in the JAX package; `convert.py` has nothing to
carry for the sidelink.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, sequence, table
from ..common.sequence import gold_sequence, gold_sequence_signed
from ..fec.convolutional import conv_encode, rm_conv_rx, rm_conv_tx, viterbi_decode
from ..fec.crc import LTE_CRC16, crc_bits, crc_ok_device
from ..mimo import equalize_zf
from ..modem.modem import Modulation, demod_soft, modulate
from ..phch.dft_precoding import dft_deprecode, dft_precode
from ..phch.dlsch import DlschConfig, dlsch_decode, dlsch_encode
from ..phch.pusch import interleaver_indices
from .common import (NRE, PSBCH_DATA_SYMS, PSBCH_E_SYMS, PSCCH_DATA_SYMS,
                     PSSCH_DATA_SYMS, SL_DMRS_SYMS, SL_E_SYMS, psbch_dmrs,
                     pscch_dmrs, pssch_dmrs)

MIB_SL_LEN = 40
SCI_CRC_LEN = 16
PSCCH_SEED = 510


@dataclass(frozen=True)
class MibSl:
    """MasterInformationBlock-SL essentials (36.331; TM1/2, 40 bits)."""

    bandwidth: int = 0  # 3 bits (sl-Bandwidth index)
    tdd_config: int = 0  # 3 bits
    direct_frame: int = 0  # 10 bits
    direct_subframe: int = 0  # 4 bits
    in_coverage: int = 0  # 1 bit
    reserved: int = 0  # 19 bits

    def pack(self) -> np.ndarray:
        bits = np.zeros(MIB_SL_LEN, np.uint8)
        pos = 0
        for val, width in ((self.bandwidth, 3), (self.tdd_config, 3),
                           (self.direct_frame, 10), (self.direct_subframe, 4),
                           (self.in_coverage, 1), (self.reserved, 19)):
            for i in range(width):
                bits[pos + i] = (val >> (width - 1 - i)) & 1
            pos += width
        return bits

    @staticmethod
    def unpack(bits: np.ndarray) -> "MibSl":
        vals, pos = [], 0
        for width in (3, 3, 10, 4, 1, 19):
            v = 0
            for i in range(width):
                v = (v << 1) | int(bits[pos + i])
            vals.append(v)
            pos += width
        return MibSl(*vals)


def _sym_grid_idx(prb0: int, n_prb: int, syms, grid_nre: int) -> np.ndarray:
    """Flat [nsym*grid_nre] indices of (syms x PRB range), symbol-major."""
    k = prb0 * NRE + np.arange(n_prb * NRE)
    return (np.asarray(syms)[:, None] * grid_nre + k[None, :]
            ).reshape(-1).astype(np.int64)


def _interleaver(g: int, qm: int, n_symb: int, device, inverse: bool = False) -> torch.Tensor:
    """The PUSCH channel interleaver of g bits over n_symb columns, or its
    inverse (the decoder's argsort)."""
    def build():
        il = interleaver_indices(g, qm, n_symb)
        return (np.argsort(il) if inverse else il).astype(np.int64)
    return table(("sl_interleaver", g, qm, n_symb, inverse), device, build)


def _put(grid, data_idx, data, dmrs_idx, dmrs):
    """grid [..., 14, nre] with data [..., n_data] and the DMRS [n_dmrs]
    written at their flat indices (a new tensor, of the batch shape that
    the grid's and the data's broadcast to)."""
    flat = grid.reshape(grid.shape[:-2] + (-1,))
    batch = torch.broadcast_shapes(flat.shape[:-1], data.shape[:-1])
    flat = torch.broadcast_to(flat, batch + flat.shape[-1:]).clone()
    flat[..., data_idx] = data
    flat[..., dmrs_idx] = dmrs
    return flat.reshape(flat.shape[:-1] + grid.shape[-2:])


def _equalized(grid, data_idx, dmrs_idx, dmrs, n_sym: int, m_sc: int):
    """Flat LS estimate over the DMRS REs, ZF, DFT de-precoding:
    grid [..., 14, nre] -> symbols [..., n_sym * m_sc]."""
    flat = grid.reshape(grid.shape[:-2] + (-1,))
    h = torch.mean(flat[..., dmrs_idx] * torch.conj(dmrs), dim=-1)
    xt = equalize_zf(flat[..., data_idx], h[..., None])
    sym = dft_deprecode(xt.reshape(xt.shape[:-1] + (n_sym, m_sc)))
    return sym.reshape(xt.shape)


def _padded_llr(sym, mod: Modulation, e: int, scr_signed, inv_il):
    """Soft bits of the sent symbols, zero LLRs for the virtual symbol that
    E counts but nobody sends, then descrambled and de-interleaved."""
    llr = demod_soft(sym, mod)
    llr = torch.cat([llr, llr.new_zeros(llr.shape[:-1] + (e - llr.shape[-1],))], -1)
    return (llr * scr_signed)[..., inv_il]


def _read_crc_and_bits(ok, bits) -> tuple[bool, np.ndarray]:
    """One host read of a CRC flag and its bits."""
    host = torch.cat([ok.reshape(1).to(torch.uint8), bits.to(torch.uint8)]).cpu().numpy()
    return bool(host[0]), host[1:]


@dataclass(frozen=True)
class Psbch:
    """PSBCH processor (center 6 PRB of the sync subframe)."""

    n_sl_id: int
    grid_prb: int = 6  # grid bandwidth in PRB

    @property
    def E(self) -> int:
        return 2 * PSBCH_E_SYMS * 6 * NRE

    def _geom(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        nre = self.grid_prb * NRE
        prb0 = self.grid_prb // 2 - 3
        return (table(("psbch_data", self.grid_prb), device,
                      lambda: _sym_grid_idx(prb0, 6, PSBCH_DATA_SYMS, nre)),
                table(("psbch_dmrs_re", self.grid_prb), device,
                      lambda: _sym_grid_idx(prb0, 6, SL_DMRS_SYMS, nre)))

    def _dmrs(self, device) -> torch.Tensor:
        return table(("psbch_dmrs", self.n_sl_id), device,
                     lambda: psbch_dmrs(self.n_sl_id).reshape(-1))

    def encode(self, mib: MibSl, grid, device=None):
        """grid [..., 14, grid_prb*12] gains PSBCH data + DMRS."""
        grid = as_tensor(grid, device).to(torch.complex64)
        dev = grid.device
        msg = np.concatenate([mib.pack(), crc_bits(mib.pack(), *LTE_CRC16)])
        k = MIB_SL_LEN + 16
        coded = rm_conv_tx(conv_encode(torch.as_tensor(msg, device=dev), k), self.E)
        coded = coded[..., _interleaver(self.E, 2, PSBCH_E_SYMS, dev)]
        scr = coded ^ table(("psbch_scr", self.n_sl_id, self.E), dev,
                            lambda: gold_sequence(self.n_sl_id, self.E))
        sym = modulate(scr, Modulation.QPSK).reshape(PSBCH_E_SYMS, 6 * NRE)
        freq = dft_precode(sym)[: len(PSBCH_DATA_SYMS)]  # drop virtual sym
        data_idx, dmrs_idx = self._geom(dev)
        return _put(grid, data_idx, freq.reshape(-1), dmrs_idx, self._dmrs(dev))

    def decode(self, grid, device=None):
        """-> (ok, MibSl)."""
        grid = as_tensor(grid, device).to(torch.complex64)
        dev = grid.device
        data_idx, dmrs_idx = self._geom(dev)
        sym = _equalized(grid, data_idx, dmrs_idx, self._dmrs(dev),
                         len(PSBCH_DATA_SYMS), 6 * NRE)
        scr = table(("psbch_scr_signed", self.n_sl_id, self.E), dev,
                    lambda: gold_sequence_signed(self.n_sl_id, self.E))
        llr = _padded_llr(sym, Modulation.QPSK, self.E, scr,
                          _interleaver(self.E, 2, PSBCH_E_SYMS, dev, inverse=True))
        k = MIB_SL_LEN + 16
        bits = viterbi_decode(rm_conv_rx(llr, 3 * k)[None], k)[0]
        ok, host = _read_crc_and_bits(crc_ok_device(bits, *LTE_CRC16), bits)
        return ok, MibSl.unpack(host[:MIB_SL_LEN])


@dataclass(frozen=True)
class Sci0:
    """SCI format 0 (36.212 §5.4.3.1, sci.c:59)."""

    riv: int
    trp_idx: int = 0  # 7 bits
    mcs: int = 0  # 5 bits
    timing_advance: int = 0  # 11 bits
    group_dst_id: int = 0  # 8 bits
    hopping: int = 0


def sci0_size(n_prb: int) -> int:
    return 1 + int(math.ceil(math.log2(n_prb * (n_prb + 1) / 2))) + 31


def pack_sci0(d: Sci0, n_prb: int) -> np.ndarray:
    bits = np.zeros(sci0_size(n_prb), np.uint8)
    riv_w = sci0_size(n_prb) - 32

    def put(pos, v, w):
        for i in range(w):
            bits[pos + i] = (int(v) >> (w - 1 - i)) & 1
        return pos + w

    pos = put(0, d.hopping, 1)
    pos = put(pos, d.riv, riv_w)
    pos = put(pos, d.trp_idx, 7)
    pos = put(pos, d.mcs, 5)
    pos = put(pos, d.timing_advance, 11)
    put(pos, d.group_dst_id, 8)
    return bits


def unpack_sci0(bits: np.ndarray, n_prb: int) -> Sci0 | None:
    riv_w = sci0_size(n_prb) - 32

    def get(pos, w):
        v = 0
        for i in range(w):
            v = (v << 1) | int(bits[pos + i])
        return v, pos + w

    hop, pos = get(0, 1)
    riv, pos = get(pos, riv_w)
    trp, pos = get(pos, 7)
    mcs, pos = get(pos, 5)
    ta, pos = get(pos, 11)
    dst, pos = get(pos, 8)
    if riv >= n_prb * (n_prb + 1) // 2:
        return None
    return Sci0(riv, trp, mcs, ta, dst, hop)


@dataclass(frozen=True)
class Pscch:
    """PSCCH processor: 1 PRB, TM1/2 (pscch.c)."""

    cell_n_prb: int  # carrier bandwidth (SCI RIV modulus)
    prb_idx: int  # the PSCCH PRB
    cyclic_shift: int = 0  # DMRS shift from the pool config {0,3,6,9}

    @property
    def E(self) -> int:
        return 2 * SL_E_SYMS * NRE

    def _geom(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        nre = self.cell_n_prb * NRE
        key = (self.cell_n_prb, self.prb_idx)
        return (table(("pscch_data", *key), device,
                      lambda: _sym_grid_idx(self.prb_idx, 1, PSCCH_DATA_SYMS, nre)),
                table(("pscch_dmrs_re", *key), device,
                      lambda: _sym_grid_idx(self.prb_idx, 1, SL_DMRS_SYMS, nre)))

    def _dmrs(self, device) -> torch.Tensor:
        return table(("pscch_dmrs", self.cyclic_shift), device,
                     lambda: pscch_dmrs(self.cyclic_shift).reshape(-1))

    def encode(self, sci: Sci0, grid, device=None):
        grid = as_tensor(grid, device).to(torch.complex64)
        dev = grid.device
        payload = pack_sci0(sci, self.cell_n_prb)
        msg = np.concatenate([payload, crc_bits(payload, *LTE_CRC16)])
        k = len(msg)
        coded = rm_conv_tx(conv_encode(torch.as_tensor(msg, device=dev), k), self.E)
        coded = coded[..., _interleaver(self.E, 2, SL_E_SYMS, dev)]
        scr = coded ^ table(("pscch_scr", self.E), dev, lambda: gold_sequence(PSCCH_SEED, self.E))
        sym = modulate(scr, Modulation.QPSK).reshape(SL_E_SYMS, NRE)
        freq = dft_precode(sym)[: len(PSCCH_DATA_SYMS)]
        data_idx, dmrs_idx = self._geom(dev)
        return _put(grid, data_idx, freq.reshape(-1), dmrs_idx, self._dmrs(dev))

    def decode(self, grid, device=None) -> Sci0 | None:
        grid = as_tensor(grid, device).to(torch.complex64)
        dev = grid.device
        data_idx, dmrs_idx = self._geom(dev)
        sym = _equalized(grid, data_idx, dmrs_idx, self._dmrs(dev), len(PSCCH_DATA_SYMS), NRE)
        scr = table(("pscch_scr_signed", self.E), dev,
                    lambda: gold_sequence_signed(PSCCH_SEED, self.E))
        llr = _padded_llr(sym, Modulation.QPSK, self.E, scr,
                          _interleaver(self.E, 2, SL_E_SYMS, dev, inverse=True))
        k = sci0_size(self.cell_n_prb) + SCI_CRC_LEN
        bits = viterbi_decode(rm_conv_rx(llr, 3 * k)[None], k)[0]
        ok, host = _read_crc_and_bits(crc_ok_device(bits, *LTE_CRC16), bits)
        if not ok:
            return None
        return unpack_sci0(host[: k - SCI_CRC_LEN], self.cell_n_prb)


@dataclass(frozen=True)
class Pssch:
    """PSSCH processor: turbo-coded data over the SCI-signaled PRBs
    (pssch.c: c_init = N_x_id*2^14 + (sf mod 10)*2^9 + 510)."""

    cell_n_prb: int
    prb_start: int
    n_prb: int
    n_x_id: int
    sf_idx: int
    mcs: int = 6  # UL-style MCS (QPSK/16QAM)

    @property
    def modulation(self) -> Modulation:
        return Modulation.QPSK if self.mcs <= 10 else Modulation.QAM16

    @property
    def tbs(self) -> int:
        from ..phch.ra_ul import ul_tbs

        return ul_tbs(self.mcs, self.n_prb)

    @functools.cached_property
    def cfg(self) -> DlschConfig:
        qm = self.modulation.bits_per_symbol
        g = qm * SL_E_SYMS * self.n_prb * NRE
        return DlschConfig(tbs=self.tbs, G=g, Qm=qm, rv=0)

    @property
    def cinit(self) -> int:
        return (self.n_x_id * 16384 + (self.sf_idx % 10) * 512 + 510) % (1 << 31)

    def _geom(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        nre = self.cell_n_prb * NRE
        key = (self.cell_n_prb, self.prb_start, self.n_prb)
        return (table(("pssch_data", *key), device,
                      lambda: _sym_grid_idx(self.prb_start, self.n_prb, PSSCH_DATA_SYMS, nre)),
                table(("pssch_dmrs_re", *key), device,
                      lambda: _sym_grid_idx(self.prb_start, self.n_prb, SL_DMRS_SYMS, nre)))

    def _dmrs(self, device) -> torch.Tensor:
        # the DMRS and the scrambling depend on the destination's N_x_id
        return sequence(("pssch_dmrs", self.n_x_id, self.n_prb), device,
                        lambda: pssch_dmrs(self.n_x_id, self.n_prb).reshape(-1))

    def encode(self, bits, grid, device=None):
        """bits [..., tbs] -> grid [..., 14, cell_n_prb*12] with the PSSCH
        and its DMRS (an unbatched grid is broadcast to the bits' batch)."""
        bits = as_tensor(bits, device)
        dev = bits.device
        grid = as_tensor(grid, dev).to(torch.complex64)
        coded = dlsch_encode(bits, self.cfg)
        coded = coded[..., _interleaver(self.cfg.G, self.cfg.Qm, SL_E_SYMS, dev)].to(torch.uint8)
        scr = coded ^ sequence(("pssch_scr", self.cinit, self.cfg.G), dev,
                               lambda: gold_sequence(self.cinit, self.cfg.G))
        sym = modulate(scr, self.modulation)
        m_sc = self.n_prb * NRE
        sym = sym.reshape(sym.shape[:-1] + (SL_E_SYMS, m_sc))
        freq = dft_precode(sym)[..., : len(PSSCH_DATA_SYMS), :]
        data_idx, dmrs_idx = self._geom(dev)
        return _put(grid, data_idx, freq.reshape(freq.shape[:-2] + (-1,)), dmrs_idx,
                    self._dmrs(dev))

    def decode(self, grid, n_iter: int = 5, device=None):
        """grid [..., 14, cell_n_prb*12] -> (bits [..., tbs] uint8, crc_ok [...])."""
        grid = as_tensor(grid, device).to(torch.complex64)
        dev = grid.device
        data_idx, dmrs_idx = self._geom(dev)
        sym = _equalized(grid, data_idx, dmrs_idx, self._dmrs(dev), len(PSSCH_DATA_SYMS),
                         self.n_prb * NRE)
        scr = sequence(("pssch_scr_signed", self.cinit, self.cfg.G), dev,
                       lambda: gold_sequence_signed(self.cinit, self.cfg.G))
        llr = _padded_llr(sym, self.modulation, self.cfg.G, scr,
                          _interleaver(self.cfg.G, self.cfg.Qm, SL_E_SYMS, dev, inverse=True))
        return dlsch_decode(llr, self.cfg, n_iter=n_iter)
