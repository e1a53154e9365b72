"""NR PUCCH formats 0-4 (38.211 §6.3.2, pucch_nr.c equivalent).

Reference behavior: lib/src/phy/phch/pucch_nr.c (format0_encode:222,
format0_measure:271, format1_encode:379, format1_decode:457,
format2_encode:553, format2_decode:596) and ch_estimation/dmrs_pucch.c.

Sequences and OCCs are precomputed on the host per (carrier, resource,
slot).  Formats 2-4 decode on the device; the format 0 and 1 detectors run
the reference's numpy correlations on the resource's REs, read back once.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..chest.refsignal_ul import base_sequence, shifted
from ..common.scrambling import scramble_bits, scramble_llr
from ..common.sequence import gold_sequence
from ..modem.modem import Modulation, demod_soft, modulate
from ..phch.dft_precoding import dft_deprecode, dft_precode
from .params import NRE, NSYMB_SLOT, NrCarrier
from .uci_nr import uci_decode, uci_encode

# 38.211 table 6.3.2.4.1-2: format 1 time-OCC phase indices rho[i][n-1][m]
_RHO = {
    (1, 2): [0, 1], (1, 3): [0, 1, 2], (1, 4): [0, 2, 0, 2],
    (1, 5): [0, 1, 2, 3, 4], (1, 6): [0, 1, 2, 3, 4, 5],
    (1, 7): [0, 1, 2, 3, 4, 5, 6],
    (2, 3): [0, 2, 1], (2, 4): [0, 0, 2, 2], (2, 5): [0, 2, 4, 1, 3],
    (2, 6): [0, 2, 4, 0, 2, 4], (2, 7): [0, 2, 4, 6, 1, 3, 5],
    (3, 4): [0, 2, 2, 0], (3, 5): [0, 3, 1, 4, 2],
    (3, 6): [0, 3, 0, 3, 0, 3], (3, 7): [0, 3, 6, 2, 5, 1, 4],
    (4, 5): [0, 4, 3, 2, 1], (4, 6): [0, 4, 2, 0, 4, 2],
    (4, 7): [0, 4, 1, 5, 2, 6, 3],
    (5, 6): [0, 5, 4, 3, 2, 1], (5, 7): [0, 5, 3, 1, 6, 4, 2],
    (6, 7): [0, 6, 5, 4, 3, 2, 1],
}


def occ_w(i: int, n: int, m: int) -> complex:
    if i == 0:
        return 1.0 + 0j
    rho = _RHO[(i, n)][m]
    return np.exp(2j * np.pi * rho / n)


# 38.211 table 6.4.1.3.3.2-1 (intra-slot frequency hopping disabled):
# DMRS symbol positions within a format 3/4 PUCCH, without / with
# additionalDMRS.
_F34_DMRS = {4: (1,), 5: (0, 3), 6: (1, 4), 7: (1, 4), 8: (1, 5), 9: (1, 6),
             10: (2, 7), 11: (2, 7), 12: (2, 8), 13: (2, 9), 14: (3, 10)}
_F34_DMRS_ADD = {**_F34_DMRS, 10: (1, 3, 6, 8), 11: (1, 3, 6, 9),
                 12: (1, 4, 7, 10), 13: (1, 4, 7, 11), 14: (1, 5, 8, 12)}

# 38.211 tables 6.3.2.6.3-1/2: format 4 pre-DFT block-spreading codes
_F4_OCC = {
    2: np.array([[1, 1], [1, -1]], np.complex64),
    4: np.array([[1, 1, 1, 1], [1, -1j, -1, 1j],
                 [1, -1, 1, -1], [1, 1j, -1, -1j]], np.complex64),
}


@dataclass(frozen=True)
class NrPucchResource:
    """One PUCCH resource (srsran_pucch_nr_resource_t subset)."""

    format: int  # 0..4
    starting_prb: int
    start_symbol: int
    nof_symbols: int
    initial_cyclic_shift: int = 0  # m0, formats 0/1
    time_domain_occ: int = 0  # format 1
    nof_prb: int = 1  # formats 2/3 (format 4 is always 1 PRB)
    occ_length: int = 2  # format 4: N_sf in {2, 4}
    occ_index: int = 0  # format 4
    additional_dmrs: bool = False  # formats 3/4


@dataclass(frozen=True)
class NrPucch:
    carrier: NrCarrier
    slot: int = 0
    hopping_id: int | None = None  # None -> PCI (group hopping 'neither')

    @property
    def _n_id(self) -> int:
        return self.carrier.n_id if self.hopping_id is None else self.hopping_id

    @property
    def _u(self) -> int:
        return self._n_id % 30

    @functools.lru_cache(maxsize=None)
    def _ncs(self, l_abs: int) -> int:
        """n_cs(n_slot, l) from the PCI-seeded gold sequence
        (pucch_nr.c srsran_pucch_nr_alpha_idx:69)."""
        bits = gold_sequence(self._n_id, (NSYMB_SLOT * self.slot + l_abs + 1) * 8)
        word = bits[(NSYMB_SLOT * self.slot + l_abs) * 8 :]
        return int(sum(int(word[m]) << m for m in range(8)))

    def _r_uv(self, alpha_idx: int) -> np.ndarray:
        n = np.arange(NRE)
        alpha = 2 * np.pi * alpha_idx / NRE
        return (base_sequence(self._u, 0, 1)
                * np.exp(1j * alpha * n)).astype(np.complex64)

    def _alpha_idx(self, l: int, l_prime: int, m0: int, m_cs: int) -> int:
        return (m0 + m_cs + self._ncs(l + l_prime)) % NRE

    @staticmethod
    def _put_rows(grid, res: NrPucchResource, rows, width: int = NRE):
        """grid with `rows` [n_symbols, width] written at the resource's
        symbols from its first subcarrier (a new tensor)."""
        k0 = res.starting_prb * NRE
        grid = grid.clone()
        grid[..., res.start_symbol : res.start_symbol + res.nof_symbols, k0 : k0 + width] = \
            as_tensor(rows, grid.device)
        return grid

    @staticmethod
    def _rows(grid, res: NrPucchResource) -> np.ndarray:
        """The resource's REs [..., n_symbols, 12] on the host (one read)."""
        k0 = res.starting_prb * NRE
        return grid[..., res.start_symbol : res.start_symbol + res.nof_symbols,
                    k0 : k0 + NRE].cpu().numpy()

    def _cinit(self, rnti: int) -> int:
        """The UCI scrambling seed (formats 2-4)."""
        return ((rnti << 15) + self._n_id) % (1 << 31)

    # -- format 0 -----------------------------------------------------------
    def format0_encode(self, grid, res: NrPucchResource, m_cs: int, device=None):
        """Sequence-selection: the UCI value picks m_cs (38.213 §9.2.3)."""
        grid = as_tensor(grid, device)
        rows = np.stack([self._r_uv(self._alpha_idx(l, res.start_symbol,
                                                     res.initial_cyclic_shift, m_cs))
                         for l in range(res.nof_symbols)])
        return self._put_rows(grid, res, rows)

    def format0_measure(self, grid, res: NrPucchResource,
                        m_cs_set: tuple[int, ...], device=None):
        """Correlate each candidate shift -> (best m_cs, corr in [0, 1])."""
        rows = self._rows(as_tensor(grid, device), res)
        corr = []
        for m_cs in m_cs_set:
            num = 0.0
            den = 0.0
            for l in range(res.nof_symbols):
                a = self._alpha_idx(l, res.start_symbol,
                                    res.initial_cyclic_shift, m_cs)
                seq = self._r_uv(a)
                y = rows[..., l, :]
                num += abs(np.vdot(seq, y))
                den += np.linalg.norm(y) * np.sqrt(NRE)
            corr.append(num / max(den, 1e-12))
        best = int(np.argmax(corr))
        return m_cs_set[best], float(corr[best])

    # -- format 1 -----------------------------------------------------------
    def _format1_tables(self, res: NrPucchResource):
        """(data [n_data, 12], dmrs [n_dmrs, 12]) spread sequences."""
        n_data = res.nof_symbols // 2
        n_dmrs = res.nof_symbols - n_data
        i = res.time_domain_occ
        data, dmrs = [], []
        for l in range(res.nof_symbols):
            a = self._alpha_idx(l, res.start_symbol, res.initial_cyclic_shift, 0)
            seq = self._r_uv(a)
            if l % 2:  # odd: data (pucch_nr.c:422 loop starts at l=1)
                m = l // 2
                data.append(seq * occ_w(i, n_data, m))
            else:  # even: DMRS (dmrs_pucch.c format1)
                m = l // 2
                dmrs.append(seq * occ_w(i, n_dmrs, m))
        return np.stack(data), np.stack(dmrs)

    def format1_encode(self, grid, res: NrPucchResource, bits, device=None):
        """1-2 UCI bits -> BPSK/QPSK symbol d on the spread sequence."""
        grid = as_tensor(grid, device)
        bits = np.asarray(as_tensor(bits, "cpu"), np.uint8)
        d = modulate(bits, Modulation.BPSK if len(bits) == 1 else Modulation.QPSK,
                     device="cpu").numpy()[0]
        data, dmrs = self._format1_tables(res)
        rows = np.zeros((res.nof_symbols, NRE), np.complex64)
        rows[1::2] = data * d
        rows[0::2] = dmrs
        return self._put_rows(grid, res, rows)

    def format1_decode(self, grid, res: NrPucchResource, nof_bits: int, device=None):
        """-> (bits, corr): channel from the DMRS symbols, then ML symbol."""
        data, dmrs = self._format1_tables(res)
        rows = self._rows(as_tensor(grid, device), res)
        y_data, h = [], []
        di = mi = 0
        for l in range(res.nof_symbols):
            y = rows[..., l, :]
            if l % 2:
                y_data.append(np.vdot(data[di], y) / NRE)
                di += 1
            else:
                h.append(np.vdot(dmrs[mi], y) / NRE)
                mi += 1
        h_est = np.mean(h)
        d_hat = np.mean(y_data) / h_est
        if nof_bits == 1:
            bits = np.array([int(d_hat.real + d_hat.imag < 0)], np.uint8)
        else:
            bits = np.array([int(d_hat.real < 0), int(d_hat.imag < 0)],
                            np.uint8)
        return bits, float(abs(h_est))

    # -- format 2 -----------------------------------------------------------
    def _format2_geometry(self, res: NrPucchResource):
        """(data_idx, dmrs_idx, dmrs_vals) flat slot-grid indices."""
        nre = self.carrier.nof_re
        k0 = res.starting_prb * NRE
        k1 = (res.starting_prb + res.nof_prb) * NRE
        data, dmrs, vals = [], [], []
        for l in range(res.start_symbol, res.start_symbol + res.nof_symbols):
            cinit = ((((NSYMB_SLOT * self.slot + l + 1) * (2 * self._n_id + 1))
                      << 17) + 2 * self._n_id) % (1 << 31)
            bits = gold_sequence(cinit, 2 * 4 * (res.starting_prb + res.nof_prb))
            r = ((1 - 2.0 * bits[0::2]) + 1j * (1 - 2.0 * bits[1::2])) / np.sqrt(2)
            for k in range(k0, k1, 3):
                data.append(l * nre + k)
                dmrs.append(l * nre + k + 1)
                # absolute pilot index: 4 per PRB from PRB 0 (dmrs_pucch.c
                # sequence_state_advance by 2*4*starting_prb)
                vals.append(r[k // 3])
                data.append(l * nre + k + 2)
        return (np.array(data, np.int32), np.array(dmrs, np.int32),
                np.array(vals, np.complex64))

    def _format2_t(self, res: NrPucchResource, device):
        key = ("nr_pucch2", self.carrier, self.slot, self._n_id, res)
        geo = functools.partial(self._format2_geometry, res)
        return (table(key + ("data",), device, lambda: geo()[0].astype(np.int64)),
                table(key + ("dmrs",), device, lambda: geo()[1].astype(np.int64)),
                table(key + ("vals",), device, lambda: geo()[2]))

    def format2_encode(self, grid, res: NrPucchResource, uci_bits, rnti: int,
                       device=None):
        grid = as_tensor(grid, device)
        dev = grid.device
        e = 16 * res.nof_prb * res.nof_symbols
        coded = scramble_bits(uci_encode(as_tensor(uci_bits, dev), e), self._cinit(rnti))
        sym = modulate(coded, Modulation.QPSK)
        data_idx, dmrs_idx, vals = self._format2_t(res, dev)
        flat = grid.reshape(grid.shape[:-2] + (-1,)).clone()
        flat[..., data_idx] = sym
        flat[..., dmrs_idx] = vals
        return flat.reshape(grid.shape)

    def format2_decode(self, grid, res: NrPucchResource, a: int, rnti: int,
                       list_size: int = 8, device=None):
        """-> (uci_bits [a], ok)."""
        grid = as_tensor(grid, device)
        data_idx, dmrs_idx, vals = self._format2_t(res, grid.device)
        flat = grid.reshape(grid.shape[:-2] + (-1,))
        ls = flat[..., dmrs_idx] * torch.conj(vals)
        # per-symbol mean channel (4 pilots/PRB), broadcast to both data REs
        nsym = res.nof_symbols
        ls_sym = ls.reshape(ls.shape[:-1] + (nsym, -1)).mean(-1)
        h = torch.repeat_interleave(ls_sym, len(data_idx) // nsym, dim=-1)
        y = flat[..., data_idx]
        xhat = y * torch.conj(h) / torch.clamp(torch.abs(h) ** 2, min=1e-12)
        llr = scramble_llr(demod_soft(xhat, Modulation.QPSK), self._cinit(rnti))
        return uci_decode(llr, a, list_size=list_size)

    # -- formats 3 / 4 (DFT-s-OFDM, 38.211 §6.3.2.5/§6.3.2.6) ----------------
    def _f34_symbols(self, res: NrPucchResource):
        """(dmrs_l, data_l): symbol offsets within the resource."""
        tab = _F34_DMRS_ADD if res.additional_dmrs else _F34_DMRS
        dmrs = tab[res.nof_symbols]
        data = tuple(l for l in range(res.nof_symbols) if l not in dmrs)
        return dmrs, data

    def _f34_dmrs_seq(self, res: NrPucchResource, l: int) -> np.ndarray:
        """Low-PAPR DMRS r_uv^(alpha) of length M (dmrs_pucch.c formats 3/4:
        m0 = 0 for format 3, the OCC-derived shift for format 4)."""
        m0 = 0
        if res.format == 4:
            m0 = res.occ_index * (NRE // res.occ_length)
        idx = self._alpha_idx(l, res.start_symbol, m0, 0)
        return shifted(self._u, 0, res.nof_prb, 2 * np.pi * idx / NRE)

    def _f34_e(self, res: NrPucchResource) -> int:
        """Coded UCI bits carried (QPSK; pi/2-BPSK halves this - not done)."""
        _, data_l = self._f34_symbols(res)
        m = res.nof_prb * NRE
        spread = res.occ_length if res.format == 4 else 1
        return len(data_l) * (m // spread) * 2

    def _f34_dmrs_t(self, res: NrPucchResource, device) -> torch.Tensor:
        """[n_dmrs, M] DMRS sequences of the resource on the device."""
        dmrs_l, _ = self._f34_symbols(res)
        return table(("nr_pucch34_dmrs", self.carrier, self.slot, self._n_id, res), device,
                     lambda: np.stack([self._f34_dmrs_seq(res, l) for l in dmrs_l]))

    def format34_encode(self, grid, res: NrPucchResource, uci_bits, rnti: int,
                        device=None):
        """Formats 3/4: UCI -> scramble -> QPSK -> (format 4: pre-DFT
        block spreading) -> transform precoding -> map; DMRS low-PAPR
        sequences on the table symbols (pucch_nr.c format 3/4 encode +
        dmrs_pucch.c).  QPSK only (no pi/2-BPSK) and no intra-slot hopping.
        """
        grid = as_tensor(grid, device)
        dev = grid.device
        m = res.nof_prb * NRE
        dmrs_l, data_l = self._f34_symbols(res)
        e = self._f34_e(res)
        coded = scramble_bits(uci_encode(as_tensor(uci_bits, dev), e), self._cinit(rnti))
        d = modulate(coded, Modulation.QPSK).reshape(len(data_l), -1)  # [n_data, e/2/n_data]
        if res.format == 4:
            w = as_tensor(_F4_OCC[res.occ_length][res.occ_index], dev)
            d = (d[:, None, :] * w[:, None]).reshape(len(data_l), -1)
        rows = torch.zeros((res.nof_symbols, m), dtype=torch.complex64, device=dev)
        rows[list(data_l)] = dft_precode(d)
        rows[list(dmrs_l)] = self._f34_dmrs_t(res, dev)
        return self._put_rows(grid, res, rows, m)

    def format34_decode(self, grid, res: NrPucchResource, a: int, rnti: int,
                        list_size: int = 8, device=None):
        """-> (uci_bits [a], ok): LS chest on the DMRS symbols, MMSE-lite
        equalize, inverse transform precoding, (format 4) despreading,
        soft demod, descramble, UCI decode."""
        grid = as_tensor(grid, device)
        dev = grid.device
        m = res.nof_prb * NRE
        dmrs_l, data_l = self._f34_symbols(res)
        k0 = res.starting_prb * NRE
        rx = grid[..., res.start_symbol : res.start_symbol + res.nof_symbols, k0 : k0 + m]
        ls = rx[..., list(dmrs_l), :] * torch.conj(self._f34_dmrs_t(res, dev))
        h = torch.mean(ls, dim=-2)  # [..., M]
        if res.format == 4:
            # average the LS estimate over the PRB: a co-scheduled UE on a
            # different cyclic shift is a full-period phase ramp across the
            # 12 subcarriers, so the PRB mean cancels it exactly
            h = torch.mean(h, dim=-1, keepdim=True).expand(h.shape)
        y = rx[..., list(data_l), :]
        xf = y * torch.conj(h)[..., None, :] / torch.clamp(torch.abs(h) ** 2, min=1e-12)[..., None, :]
        x = dft_deprecode(xf)
        if res.format == 4:
            w = as_tensor(_F4_OCC[res.occ_length][res.occ_index], dev)
            chunks = x.reshape(x.shape[:-1] + (res.occ_length, m // res.occ_length))
            x = (chunks * torch.conj(w)[:, None]).sum(-2) / res.occ_length
        llr = scramble_llr(demod_soft(x, Modulation.QPSK).reshape(x.shape[:-2] + (-1,)),
                           self._cinit(rnti))
        return uci_decode(llr, a, list_size=list_size)
