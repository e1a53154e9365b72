"""NR PDCCH: CORESET geometry, DMRS, polar-coded DCI encode + blind search
(38.211 §7.3.2/§7.4.1.3, 38.212 §7.3, 38.213 §10.1).

Reference behavior: lib/src/phy/phch/pdcch_nr.c (srsran_pdcch_nr_encode:356,
srsran_pdcch_nr_decode:456, srsran_pdcch_calculate_Y_p_n:41, pdcch_nr_cp:309)
and lib/src/phy/ch_estimation/dmrs_pdcch.c (cinit:57, put_symbol:64).

Candidate RE sets and DMRS sequences are precomputed gathers per (coreset,
location) bucket; the blind search decodes every location of one
aggregation level as one batch of the SCL list decoder (phy/fec/polar.py),
reads all candidates back in one host transfer, and selects with the
CRC24C on the host in the reference's order.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.scrambling import scramble_bits, scramble_llr
from ..common.sequence import gold_sequence
from ..fec.crc import NR_CRC24C, crc_bits
from ..fec.polar import PolarCode, input_interleaver, polar_decode_list, polar_encode
from ..modem.modem import Modulation, demod_soft, modulate
from .params import NRE, NSYMB_SLOT, NrCarrier

NOF_PILOTS_PER_GROUP = 18  # 3 pilots/RB x 6 RB


@dataclass(frozen=True)
class Coreset:
    """Control resource set: bitmap over 6-RB groups x 1-3 symbols.

    interleaved=True enables the 38.211 §7.3.2.2 interleaved CCE-to-REG
    mapping (REG bundles of reg_bundle_size REGs, block interleaver with
    interleaver_size rows, shift n_shift = shift_index or N_ID_cell).
    """

    freq_resources: tuple[bool, ...]
    duration: int = 1
    id: int = 0
    dmrs_scrambling_id: int | None = None
    interleaved: bool = False
    reg_bundle_size: int = 6  # L in {2, 6} (dur 1-2) / {3, 6} (dur 3)
    interleaver_size: int = 2  # R in {2, 3, 6}
    shift_index: int | None = None  # n_shift; None -> N_ID_cell

    @property
    def bw_prb(self) -> int:
        return 6 * sum(self.freq_resources)

    @property
    def n_cce(self) -> int:
        return self.bw_prb * self.duration // 6

    @staticmethod
    def full(n_prb: int, duration: int = 1, id: int = 0) -> "Coreset":
        return Coreset(tuple([True] * (n_prb // 6)), duration, id)


@dataclass(frozen=True)
class NrSearchSpace:
    """Candidate counts per aggregation level 1/2/4/8/16 (38.213 table)."""

    ue_specific: bool = True
    nof_candidates: tuple[int, ...] = (0, 0, 2, 2, 0)


def _y_p_n(coreset_id: int, rnti: int, slot: int) -> int:
    """38.213 §10.1 UE-specific search-space hash (pdcch_nr.c:41)."""
    a = (39827, 39829, 39839)[coreset_id % 3]
    y = rnti
    for _ in range(slot + 1):
        y = (a * y) % 65537
    return y


def pdcch_nr_locations(coreset: Coreset, ss: NrSearchSpace, rnti: int,
                       agg_idx: int, slot: int) -> list[int]:
    """CCE start indices of the candidates at aggregation level 2^agg_idx."""
    L = 1 << agg_idx
    n_cce = coreset.n_cce
    m_max = ss.nof_candidates[agg_idx]
    if n_cce < L or m_max == 0:
        return []
    y = _y_p_n(coreset.id, rnti, slot) if ss.ue_specific else 0
    return [L * ((y + (m * n_cce) // (L * m_max)) % (n_cce // L))
            for m in range(m_max)]


@functools.lru_cache(maxsize=None)
def _candidate_res(carrier: NrCarrier, coreset: Coreset, ncce: int,
                   agg_l: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(data_idx [M], dmrs_idx [Np], dmrs_seq_pos [Np]) for one candidate.

    data_idx / dmrs_idx are flat slot-grid indices (l * nof_re + k);
    dmrs_seq_pos is the pilot's index into that symbol's gold sequence
    (absolute 6-RB-group position times 18, dmrs_pdcch.c sequence_skip).
    """
    dur = coreset.duration
    data, dmrs, seq = [], [], []
    if coreset.interleaved:
        # 38.211 §7.3.2.2: REGs numbered time-first over the active PRBs;
        # bundle j = REGs {jL..jL+L-1}; CCE i owns bundles f(6i/L + m)
        # with f(cR + r) = (rC + c + n_shift) mod n_bundles.
        Lb, R = coreset.reg_bundle_size, coreset.interleaver_size
        prbs = [6 * g + o for g, a in enumerate(coreset.freq_resources)
                if a for o in range(6)]
        n_bund = len(prbs) * dur // Lb
        if n_bund % R:
            raise ValueError(f"interleaver: {n_bund} bundles not divisible"
                             f" by R={R}")
        C = n_bund // R
        shift = (carrier.n_id if coreset.shift_index is None
                 else coreset.shift_index)
        per_cce = 6 // Lb
        for i in range(agg_l):
            for m in range((ncce + i) * per_cce, (ncce + i + 1) * per_cce):
                c_col, r_row = divmod(m, R)
                b = (r_row * C + c_col + shift) % n_bund
                for reg in range(b * Lb, (b + 1) * Lb):
                    l, prb = reg % dur, prbs[reg // dur]
                    for k in range(prb * NRE, (prb + 1) * NRE):
                        if k % 4 == 1:
                            dmrs.append(l * carrier.nof_re + k)
                            seq.append(k // 4)
                        else:
                            data.append(l * carrier.nof_re + k)
        # map in increasing (l, k) like the contiguous path, so the per-RB
        # pilot/data alignment the equalizer relies on is preserved
        data.sort()
        order = np.argsort(np.array(dmrs))
        return (np.array(data, np.int32), np.array(dmrs, np.int32)[order],
                np.array(seq, np.int64)[order])
    k_begin = ncce * 6 * NRE // dur
    k_end = k_begin + agg_l * 6 * NRE // dur
    for l in range(dur):
        k = 0  # RE counter over the CORESET's active groups
        for g, active in enumerate(coreset.freq_resources):
            if not active:
                continue
            for i in range(g * 6 * NRE, (g + 1) * 6 * NRE):
                if k_begin <= k < k_end:
                    if i % 4 == 1:
                        dmrs.append(l * carrier.nof_re + i)
                        # pilot index within symbol: 18 per absolute group
                        seq.append(g * NOF_PILOTS_PER_GROUP
                                   + (i - g * 6 * NRE) // 4)
                    else:
                        data.append(l * carrier.nof_re + i)
                k += 1
    return (np.array(data, np.int32), np.array(dmrs, np.int32),
            np.array(seq, np.int64))


def _dmrs_cinit(slot: int, l: int, n_id: int) -> int:
    return ((((NSYMB_SLOT * slot + l + 1) * (2 * n_id + 1)) << 17)
            + 2 * n_id) % (1 << 31)


@functools.lru_cache(maxsize=None)
def _dmrs_values(carrier: NrCarrier, coreset: Coreset, slot: int, n_id: int,
                 ncce: int, agg_l: int) -> np.ndarray:
    """QPSK pilot values aligned with _candidate_res dmrs positions."""
    _, dmrs_idx, seq_pos = _candidate_res(carrier, coreset, ncce, agg_l)
    n_groups = len(coreset.freq_resources)
    vals = np.zeros(len(dmrs_idx), np.complex64)
    for l in range(coreset.duration):
        cinit = _dmrs_cinit(slot, l, n_id)
        bits = gold_sequence(cinit, 2 * NOF_PILOTS_PER_GROUP * n_groups)
        r = ((1 - 2.0 * bits[0::2]) + 1j * (1 - 2.0 * bits[1::2])) / np.sqrt(2)
        sel = (dmrs_idx // carrier.nof_re) == l
        vals[sel] = r[seq_pos[sel]]
    return vals


@dataclass(frozen=True)
class NrPdcch:
    """PDCCH processor for one (carrier, coreset, slot)."""

    carrier: NrCarrier
    coreset: Coreset
    slot: int = 0

    def _n_id(self) -> int:
        cid = self.coreset.dmrs_scrambling_id
        return self.carrier.n_id if cid is None else cid

    def _scr_cinit(self, rnti: int) -> int:
        """Data scrambling c_init (pdcch_nr.c pdcch_nr_c_init:345)."""
        if self.coreset.dmrs_scrambling_id is None:
            return self.carrier.n_id
        return ((rnti << 16) + self.coreset.dmrs_scrambling_id) & 0x7FFFFFFF

    @staticmethod
    def _attach_crc(payload: np.ndarray, rnti: int) -> np.ndarray:
        """CRC24C over the ones-prefixed payload; last 16 bits XOR RNTI."""
        ones = np.ones(24, np.uint8)
        crc = crc_bits(np.concatenate([ones, payload]), *NR_CRC24C)
        rnti_bits = np.array([(rnti >> (15 - i)) & 1 for i in range(16)],
                             np.uint8)
        crc[-16:] ^= rnti_bits
        return np.concatenate([payload, crc])

    def _tables(self, ncce: int, agg_l: int, device):
        """(data_idx, dmrs_idx, dmrs values) of one candidate on the device."""
        key = ("nr_pdcch", self.carrier, self.coreset, self.slot, self._n_id(), ncce, agg_l)
        res = functools.partial(_candidate_res, self.carrier, self.coreset, ncce, agg_l)
        data = table(key + ("data",), device, lambda: res()[0].astype(np.int64))
        dmrs = table(key + ("dmrs",), device, lambda: res()[1].astype(np.int64))
        vals = table(key + ("vals",), device, lambda: _dmrs_values(
            self.carrier, self.coreset, self.slot, self._n_id(), ncce, agg_l))
        return data, dmrs, vals

    # -- gNB side -----------------------------------------------------------
    def encode(self, grid, payload, rnti: int, ncce: int, agg_l: int, device=None):
        """Encode one DCI. grid [..., NSYMB_SLOT, nof_re] complex64; the same
        DCI goes into every grid of the batch."""
        grid = as_tensor(grid, device)
        dev = grid.device
        payload = np.asarray(as_tensor(payload, "cpu"), np.uint8)
        k = len(payload) + 24
        m = agg_l * 6 * (NRE - 3)
        e = 2 * m
        c = self._attach_crc(payload, rnti)
        code = PolarCode(K=k, E=e, n_max=9)
        f = polar_encode(c[input_interleaver(k)], code, device=dev)
        sym = modulate(scramble_bits(f, self._scr_cinit(rnti)), Modulation.QPSK)
        data_idx, dmrs_idx, vals = self._tables(ncce, agg_l, dev)
        flat = grid.reshape(grid.shape[:-2] + (-1,)).clone()
        flat[..., data_idx] = sym
        flat[..., dmrs_idx] = vals
        return flat.reshape(grid.shape)

    # -- UE side ------------------------------------------------------------
    def _chest(self, flat_grid, ncce: int, agg_l: int):
        """Per-RB LS estimate from the candidate's own DMRS -> per-data-RE h."""
        _, dmrs_idx, vals = self._tables(ncce, agg_l, flat_grid.device)
        ls = flat_grid[..., dmrs_idx] * torch.conj(vals)
        # average the 3 pilots of each RB, broadcast to that RB's 9 data REs
        ls_rb = ls.reshape(ls.shape[:-1] + (-1, 3)).mean(-1)
        h = torch.repeat_interleave(ls_rb, 9, dim=-1)
        nvar = torch.mean(torch.abs(ls - torch.repeat_interleave(ls_rb, 3, dim=-1)) ** 2, dim=-1)
        return h, torch.clamp(nvar, min=1e-9)

    def candidate_llr(self, flat_grid, rnti: int, ncce: int, agg_l: int):
        """Descrambled LLRs [..., E] of one candidate (positive => bit 1)."""
        data_idx, _, _ = self._tables(ncce, agg_l, flat_grid.device)
        h, nvar = self._chest(flat_grid, ncce, agg_l)
        y = flat_grid[..., data_idx]
        xhat = y * torch.conj(h) / torch.clamp(torch.abs(h) ** 2, min=1e-12)
        w = torch.abs(h) ** 2 / nvar[..., None]
        llr = demod_soft(xhat, Modulation.QPSK)
        llr = llr * torch.repeat_interleave(w, 2, dim=-1)
        return scramble_llr(llr, self._scr_cinit(rnti))

    def search(self, grid, rnti: int, payload_len: int,
               locations: list[tuple[int, int]], list_size: int = 8, device=None):
        """Blind search: try each (ncce, agg_l); return (loc, bits) or None.

        CA-SCL: the list decoder returns `list_size` candidates per
        location; the CRC24C (RNTI-unmasked) picks the winner.  The locations
        of one aggregation level decode as one batch; all candidates come
        back in one host read and are walked in the order of `locations`,
        best path first, as the reference walks them.
        """
        grid = as_tensor(grid, device)
        flat = grid.reshape(grid.shape[:-2] + (-1,))
        k = payload_len + 24
        inv_il = np.argsort(input_interleaver(k))
        groups = {}  # agg_l -> [location index]
        for i, (_, agg_l) in enumerate(locations):
            groups.setdefault(agg_l, []).append(i)
        decoded = []
        for agg_l, which in groups.items():
            llr = torch.stack([self.candidate_llr(flat, rnti, locations[i][0], agg_l)
                               for i in which])
            code = PolarCode(K=k, E=llr.shape[-1], n_max=9)
            decoded.append(polar_decode_list(llr, code, L=list_size))
        if not decoded:
            return None
        host = torch.cat([d.reshape(-1) for d in decoded]).cpu().numpy()
        cands, pos = {}, 0
        for which in groups.values():
            n = len(which) * list_size * k
            for i, c in zip(which, host[pos : pos + n].reshape(len(which), list_size, k)):
                cands[i] = c
            pos += n
        rnti_bits = np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.uint8)
        ones = np.ones(24, np.uint8)
        for i, loc in enumerate(locations):
            for c_prime in cands[i]:
                c = c_prime[inv_il]
                payload, crc = c[:payload_len], c[payload_len:].copy()
                crc[-16:] ^= rnti_bits
                want = crc_bits(np.concatenate([ones, payload]), *NR_CRC24C)
                if np.array_equal(crc, want):
                    return tuple(loc), payload
        return None
