# Frozen copy of srslte_tpu_torch/phy/phch/pbch.py at commit e4337f4, unchanged but for this line.
"""PBCH: broadcast channel carrying the MIB (36.211 §6.6, 36.212 §5.3.1).

Reference behavior: lib/src/phy/phch/pbch.c: MIB pack (srsran_pbch_mib_pack),
CRC16 masked by the antenna-port pattern (36.212 table 5.3.1.1-1), K=7
tail-biting convolutional code, rate matching to 1920 bits (normal CP),
cell-id scrambling reset every 4 frames, QPSK, SFBC, mapping to slot 1
symbols 0-3 of subframe 0 over the center 72 subcarriers skipping 4-port CRS
positions; decode tries every (frame-phase, antenna-count) hypothesis
(srsran_pbch_decode:444).

All 4 frame phases x {1, 2} antenna hypotheses (x {1, 2, 4} from a 4-port
estimate) decode as one de-rate-matching gather, one Viterbi kernel launch at
[8, 120] -> [8, 40] ([12, 120] with 4 ports) and one CRC product; the C
library's nested hypothesis loops become a leading axis and an argmax.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table, take
from ...utils.jit import lazy_jit
from ..common.params import CP, Cell
from ..common.sequence import gold_sequence, gold_sequence_signed
from ..fec.convolutional import conv_encode_np, rm_conv_indices, rm_conv_rx, viterbi_decode
from ..fec.crc import LTE_CRC16, crc_bits, crc_calc
from ..mimo import alamouti_decode_2tx, equalize_zf
from ..mimo.mimo import alamouti_decode_4tx, diversity_put
from ..modem.modem import Modulation, demod_soft, modulate

MIB_LEN = 24
PAYLOAD = MIB_LEN + 16  # with CRC
_BW_IDX = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}
_BW_REV = {v: k for k, v in _BW_IDX.items()}
_RES_IDX = {"1/6": 0, "1/2": 1, "1": 2, "2": 3}
_RES_REV = {v: k for k, v in _RES_IDX.items()}


def ant_mask(nof_ports: int) -> np.ndarray:
    """CRC mask per 36.212 table 5.3.1.1-1."""
    if nof_ports == 1:
        return np.zeros(16, np.uint8)
    if nof_ports == 2:
        return np.ones(16, np.uint8)
    return np.tile(np.array([0, 1], np.uint8), 8)


@dataclass(frozen=True)
class Mib:
    n_prb: int
    phich_length: str
    phich_resources: str
    sfn: int  # multiple of 4 (the 2 LSBs come from the decoded frame phase)

    def pack(self) -> np.ndarray:
        bits = np.zeros(MIB_LEN, np.uint8)
        bw = _BW_IDX[self.n_prb]
        bits[0:3] = [(bw >> i) & 1 for i in (2, 1, 0)]
        bits[3] = 0 if self.phich_length == "norm" else 1
        res = _RES_IDX[self.phich_resources]
        bits[4:6] = [(res >> 1) & 1, res & 1]
        sfn8 = (self.sfn >> 2) & 0xFF
        bits[6:14] = [(sfn8 >> i) & 1 for i in range(7, -1, -1)]
        return bits

    @staticmethod
    def unpack(bits: np.ndarray) -> "Mib":
        bw = (bits[0] << 2) | (bits[1] << 1) | bits[2]
        res = (bits[4] << 1) | bits[5]
        sfn8 = 0
        for b in bits[6:14]:
            sfn8 = (sfn8 << 1) | int(b)
        return Mib(n_prb=_BW_REV[int(bw)],
                   phich_length="norm" if bits[3] == 0 else "ext",
                   phich_resources=_RES_REV[int(res)], sfn=sfn8 << 2)


@functools.lru_cache(maxsize=None)
def pbch_re_indices(cell: Cell) -> np.ndarray:
    """Flat subframe-grid indices of the PBCH REs (240 normal / 216 ext CP).

    Slot 1 symbols 0-3, center 72 subcarriers, skipping the 4-port CRS
    pattern (k mod 3 == cell_id mod 3) regardless of actual port count
    (36.211 §6.6.4).  Normal CP: CRS live in symbols 0-1 of the PBCH block;
    extended CP: ports 0/1 fall on symbols 0 and 3, ports 2/3 on symbol 1,
    so symbols 0, 1 and 3 are punctured (pbch.c PBCH_RE_EXT_CP).
    """
    o = cell.ofdm
    crs_syms = (0, 1) if cell.cp is CP.NORM else (0, 1, 3)
    first = o.nof_re // 2 - 36
    idx = []
    for l in range(4):
        sym = o.nsymb_slot + l
        ks = np.arange(first, first + 72)
        if l in crs_syms:
            ks = ks[ks % 3 != cell.id % 3]
        idx.append(sym * o.nof_re + ks)
    out = np.concatenate(idx).astype(np.int32)
    assert len(out) == (240 if cell.cp is CP.NORM else 216)
    return out


_E_TOTAL = 1920  # normal CP: 4 x 480 coded bits (ext CP: 4 x 432)


def e_total(cell: Cell) -> int:
    return 1920 if cell.cp is CP.NORM else 1728


@functools.lru_cache(maxsize=None)
def _scramble_signed(cell_id: int, e: int = _E_TOTAL) -> np.ndarray:
    return gold_sequence_signed(cell_id, e)


@functools.lru_cache(maxsize=None)
def _quarter_index(e: int) -> np.ndarray:
    """[4, e/4] positions of each frame phase's quarter in the flattened
    [4, e] hypothesis buffer: phase ph's LLRs sit at offset ph * e/4 of
    row ph."""
    q = e // 4
    return np.stack([ph * e + q * ph + np.arange(q) for ph in range(4)])


@dataclass(frozen=True)
class Pbch:
    cell: Cell

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        return pbch_re_indices(self.cell)

    def _re_idx_t(self, device) -> torch.Tensor:
        return table(("pbch_re", self.cell), device, lambda: self.re_idx.astype(np.int64))

    def encode_frame(self, mib: Mib, grids, device=None):
        """Encode the MIB burst for frame phase (sfn mod 4) into grids (a new
        tensor).

        grids: subframe-0 grids [..., nports, nsym, nre].  The full 1920-bit
        codeword is built on the host per 4-frame period (config-plane
        data); the phase selects the 480-bit quarter.
        """
        grids = as_tensor(grids, device)
        phase = mib.sfn % 4
        e = e_total(self.cell)
        q = e // 4
        msg = mib.pack()
        crc = crc_bits(msg, *LTE_CRC16) ^ ant_mask(self.cell.nof_ports)
        payload = np.concatenate([msg, crc])
        coded = conv_encode_np(payload)[rm_conv_indices(3 * PAYLOAD, e)]
        scr = coded ^ gold_sequence(self.cell.id, e)
        sym = modulate(as_tensor(scr[q * phase : q * (phase + 1)], grids.device),
                       Modulation.QPSK)  # [240] (216 ext CP)
        o = self.cell.ofdm
        idx = self._re_idx_t(grids.device)
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        diversity_put(flat, idx, sym, self.cell.nof_ports)
        return flat.reshape(grids.shape)

    def decode(self, grid, ce, device=None):
        """Single-frame blind decode over (phase, ports) hypotheses.

        grid [nsym, nre], ce [nports_est>=2, nsym, nre] (CRS estimated for 2
        ports; the 1-port hypothesis uses ce[0] only).  Returns (ok,
        mib_bits[40], phase, nof_ports) on the host, read back after one
        batched pass (the bits are the decoded 24+16 payload, CRC already
        checked against the winning antenna mask).
        """
        ok, bits, win = self._decode_dev(grid, ce, device)
        win = int(win)
        return bool(ok), bits.cpu().numpy(), win % 4, (1, 2, 4)[win // 4]

    @lazy_jit(static_argnums=(0,))
    def _decode_dev(self, grid, ce, device=None):
        """All (phase x ports) hypotheses in one pass -> (any_ok, bits, win).

        Port hypotheses 1 and 2 always; 4 when ce carries 4 estimated ports
        (pbch.c srsran_pbch_decode:444 tries nant in {1, 2, 4}).
        """
        grid = as_tensor(grid, device)
        ce = as_tensor(ce, grid.device)
        dev = grid.device
        e = e_total(self.cell)
        q = e // 4
        idx = self._re_idx_t(dev)
        y = grid.reshape(-1)[idx]
        h0 = ce[0].reshape(-1)[idx]
        h1 = ce[1].reshape(-1)[idx]
        x1 = equalize_zf(y, h0)
        x2 = alamouti_decode_2tx(y, h0, h1)
        hyps = [demod_soft(x1, Modulation.QPSK), demod_soft(x2, Modulation.QPSK)]
        ports = (1, 2)
        if ce.shape[0] >= 4:
            x4, _ = alamouti_decode_4tx(y, ce[:4].reshape(4, -1)[:, idx])
            hyps.append(demod_soft(x4, Modulation.QPSK))
            ports = (1, 2, 4)
        nh = len(ports)
        llr_hyp = torch.stack(hyps)  # [nh, q]
        s = table(("pbch_scr", self.cell.id, e), dev, lambda: _scramble_signed(self.cell.id, e))
        # place the quarter LLRs at each of the 4 offsets of the e buffer
        qidx = table(("pbch_quarters", e), dev, lambda: _quarter_index(e).astype(np.int64))
        buf = torch.zeros((nh, 4 * e), dtype=torch.float32, device=dev)
        buf[:, qidx] = llr_hyp[:, None, :]
        buf = (buf.reshape(nh, 4, e) * s).reshape(nh * 4, e)
        de_rm = rm_conv_rx(buf, 3 * PAYLOAD)  # [nh*4, 120]
        bits = viterbi_decode(de_rm, PAYLOAD)  # [nh*4, 40]
        calc = crc_calc(bits[:, :MIB_LEN], *LTE_CRC16).to(torch.int32)
        rx = bits[:, MIB_LEN:].to(torch.int32)
        masks = table(("pbch_masks", ports), dev,
                      lambda: np.repeat(np.stack([ant_mask(p) for p in ports]), 4, axis=0)
                      .astype(np.int32))
        ok = torch.all(calc == (rx ^ masks), dim=-1)
        win = torch.argmax(ok.to(torch.int32))  # the first hypothesis that passes
        return torch.any(ok), take(bits, win), win
