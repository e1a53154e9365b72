"""PUCCH: uplink control channel, formats 1/1a/1b and 2/2a/2b (36.211 §5.4).

Reference behavior: lib/src/phy/phch/pucch.c + pucch_proc.c and
ch_estimation/refsignal_ul.c (PUCCH DMRS):
- cell-specific cyclic-shift hopping n_cs_cell(ns, l) from the Gold sequence
  seeded with the cell id (srsran_pucch_n_cs_cell, pucch.c:1018),
- format-1 resource algebra n' / n_oc / alpha (srsran_pucch_alpha_format1),
- format-2 alpha (srsran_pucch_alpha_format2) and the (20, A) Reed-Muller
  block code (uci.c M_basis_seq_pucch = 36.212 table 5.2.3.3-1),
- OCC tables 5.4.1-2/3 and DMRS w̄ tables (refsignal_ul.c:46-56),
- PRB mapping with slot hopping m -> n_PRB (36.211 §5.4.3).

An entire PUCCH transmission is two [nsym_slot, 12] constant tensors
(built on the host per resource/subframe bucket and uploaded once) scaled
by the data symbol(s); decoding is despread-by-product + DMRS MRC, and the
RM(20, A) decode correlates against the full 2^A codebook in one matrix
product (pucch.c decodes bit-serially).  The payload's block coding runs on
the host (it is a few bits per subframe); modulation, spreading and the RE
mapping run on the device.

Format 3 (36.211 §5.4.2A, pucch.c encode/decode_signal_format3): up to 11
ACK+SR bits -> (32, O) block code repeated to 48 bits -> scrambled QPSK ->
12 symbols per slot, block-spread over the 5 data SC-FDMA symbols with a
DFT-5 OCC (n_oc0 = n_pucch mod 5, n_oc1 = 3*n_pucch mod 5), cyclic-shifted
by n_cs_cell, phase-rotated by pi*floor(n_cs_cell/64)/2, and DFT-precoded.
All of that is linear in the 12 data symbols, so here each slot is ONE
constant [5, 12, 12] tensor (host-precomputed per bucket) applied by
einsum; the reference loops symbol-by-symbol with explicit O(N^2) DFTs.
Shortened (SRS) subframes drop the last symbol of slot 1 (formats 1*/3).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, resolve, sequence, table
from ..chest.refsignal_ul import base_sequence
from ..common.params import CP, Cell
from ..common.sequence import gold_sequence
from ..fec.block import block_decode, block_encode
from ..modem.modem import Modulation, demod_soft, modulate

NRE = 12
# data symbol indices within a slot (normal CP)
F1_DATA_SYMS = (0, 1, 5, 6)
F1_DMRS_SYMS = (2, 3, 4)
F2_DATA_SYMS = (0, 2, 3, 4, 6)
F2_DMRS_SYMS = (1, 5)
# extended CP (pucch.c pucch_symbol_*_cpext, refsignal_ul.c dmrs tables)
F1_DATA_SYMS_EXT = (0, 1, 4, 5)
F1_DMRS_SYMS_EXT = (2, 3)
F2_DATA_SYMS_EXT = (0, 1, 2, 4, 5)
F2_DMRS_SYMS_EXT = (3,)


def f1_syms(cp: CP) -> tuple[tuple, tuple]:
    """(data symbols, DMRS symbols) per slot for format 1/1a/1b."""
    if cp is CP.NORM:
        return F1_DATA_SYMS, F1_DMRS_SYMS
    return F1_DATA_SYMS_EXT, F1_DMRS_SYMS_EXT


def f2_syms(cp: CP) -> tuple[tuple, tuple]:
    if cp is CP.NORM:
        return F2_DATA_SYMS, F2_DMRS_SYMS
    return F2_DATA_SYMS_EXT, F2_DMRS_SYMS_EXT


# 36.211 tables 5.4.1-2/3: OCC phase arguments for N_sf=4 and N_sf=3
_W_F1_DATA = np.array([[0, 0, 0, 0], [0, np.pi, 0, np.pi], [0, np.pi, np.pi, 0]])
_W_F1_DATA_SF3 = np.array([[0, 0, 0], [0, 2 * np.pi / 3, 4 * np.pi / 3],
                           [0, 4 * np.pi / 3, 2 * np.pi / 3]])
_W_F1_DMRS = np.array([[0, 0, 0], [0, 2 * np.pi / 3, 4 * np.pi / 3],
                       [0, 4 * np.pi / 3, 2 * np.pi / 3]])
# ext-CP DMRS OCC (refsignal_ul.c w_arg_pucch_format1_cpext)
_W_F1_DMRS_EXT = np.array([[0, 0], [0, np.pi], [0, 0]])

# 36.212 table 5.2.3.3-1: (20, 13) Reed-Muller basis
_RM20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0], [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1], [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1], [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1], [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1], [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1], [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1], [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1], [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1], [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
], np.uint8)


def rm20_encode(bits: np.ndarray) -> np.ndarray:
    """(20, A) block code, A <= 13: bits [A] -> codeword [20]."""
    a = len(bits)
    return (_RM20_BASIS[:, :a] @ np.asarray(bits, np.uint8)) % 2


@functools.lru_cache(maxsize=None)
def _rm20_codebook(a: int) -> np.ndarray:
    """All 2^a codewords as ±1 rows [2^a, 20] (+1 for bit 0)."""
    msgs = (np.arange(2**a)[:, None] >> np.arange(a)[None, :]) & 1
    cws = (msgs.astype(np.uint8) @ _RM20_BASIS[:, :a].T) % 2
    return (1.0 - 2.0 * cws.astype(np.float32))


@functools.lru_cache(maxsize=None)
def n_cs_cell(cell: Cell) -> np.ndarray:
    """[20 slots, nsymb] cell cyclic-shift hopping (pucch.c:1018)."""
    nsym = cell.cp.nsymb
    c = gold_sequence(cell.id, 8 * nsym * 20)
    ns, l, i = np.meshgrid(np.arange(20), np.arange(nsym), np.arange(8),
                           indexing="ij")
    bits = c[8 * nsym * ns + 8 * l + i]
    return (bits << i).sum(axis=-1).astype(np.int64)


@dataclass(frozen=True)
class PucchConfig:
    fmt: str  # '1' | '1a' | '1b' | '2' | '2a' | '2b' | '3'
    n_pucch: int
    delta_shift: int = 1
    n_cs_1: int = 0  # N_cs^(1)
    n_rb_2: int = 0  # N_RB^(2)

    @property
    def is_format1(self) -> bool:
        return self.fmt.startswith("1")

    @property
    def nof_ack_bits(self) -> int:
        return {"1": 0, "1a": 1, "1b": 2, "2": 0, "2a": 1, "2b": 2,
                "3": 0}[self.fmt]


def _alpha_format1(cell: Cell, cfg: PucchConfig, ns: int, l: int):
    """-> (alpha, n_oc, n_prime) per srsran_pucch_alpha_format1 semantics."""
    c = 3 if cell.cp is CP.NORM else 2
    thr = c * cfg.n_cs_1 // cfg.delta_shift
    n_prime_res = cfg.n_cs_1 if cfg.n_pucch < thr else NRE
    n_prime = cfg.n_pucch
    if cfg.n_pucch >= thr:
        n_prime = (cfg.n_pucch - thr) % (c * NRE // cfg.delta_shift)
    if ns % 2:
        if cfg.n_pucch >= thr:
            n_prime = (c * (n_prime + 1)) % (c * NRE // cfg.delta_shift + 1) - 1
        else:
            d = 2 if cell.cp is CP.NORM else 0
            h = (n_prime + d) % (c * n_prime_res // cfg.delta_shift)
            n_prime = h // c + (h % c) * n_prime_res // cfg.delta_shift
    n_oc = n_prime * cfg.delta_shift // n_prime_res
    if cell.cp is CP.NORM:
        shift = (n_prime * cfg.delta_shift + n_oc % cfg.delta_shift)
    else:  # extended CP uses the full n_oc term (pucch.c:1193)
        shift = (n_prime * cfg.delta_shift + n_oc)
    ncs = (int(n_cs_cell(cell)[ns, l]) + shift % n_prime_res) % NRE
    return 2 * np.pi * ncs / NRE, n_oc, n_prime


def _alpha_format2(cell: Cell, cfg: PucchConfig, ns: int, l: int) -> float:
    n_prime = cfg.n_pucch % NRE
    if cfg.n_pucch >= NRE * cfg.n_rb_2:
        n_prime = (cfg.n_pucch + cfg.n_cs_1 + 1) % NRE
    if ns % 2:
        n_prime = (NRE * (n_prime + 1)) % (NRE + 1) - 1
        if cfg.n_pucch >= NRE * cfg.n_rb_2:
            n_prime = (NRE - 2 - cfg.n_pucch) % NRE
    ncs = (int(n_cs_cell(cell)[ns, l]) + n_prime) % NRE
    return 2 * np.pi * ncs / NRE


def pucch_m(cell: Cell, cfg: PucchConfig) -> int:
    """PRB-pair index m (36.211 §5.4.3, srsran_pucch_m)."""
    if cfg.is_format1:
        c = 3 if cell.cp is CP.NORM else 2
        thr = c * cfg.n_cs_1 // cfg.delta_shift
        if cfg.n_pucch < thr:
            return cfg.n_rb_2
        return ((cfg.n_pucch - thr) // (c * NRE // cfg.delta_shift)
                + cfg.n_rb_2 + int(np.ceil(cfg.n_cs_1 / 8)))
    if cfg.fmt == "3":
        return cfg.n_pucch // 5
    return cfg.n_pucch // NRE


def pucch_prb(cell: Cell, cfg: PucchConfig, ns: int) -> int:
    m = pucch_m(cell, cfg)
    if (m + ns) % 2 == 0:
        return m // 2
    return cell.n_prb - 1 - m // 2


def _rseq(cell: Cell, alpha: float) -> np.ndarray:
    """r_u^alpha over 12 subcarriers (group u = cell_id mod 30, no hopping)."""
    u = cell.id % 30
    n = np.arange(NRE)
    return (base_sequence(u, 0, 1) * np.exp(1j * alpha * n)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _format1_tables(cell: Cell, cfg_key: tuple, sf_idx: int,
                    shortened: bool = False):
    """(data_seq [2][N_sf,12], dmrs_seq [2][N_rs,12], prb [2]) — d0-free.

    `shortened`: SRS-colliding subframe — slot 1 drops its last data symbol
    and spreads with the N_sf=3 OCC (pucch.c get_N_sf)."""
    cfg = PucchConfig(*cfg_key)
    dsy, msy = f1_syms(cell.cp)
    wdm = _W_F1_DMRS if cell.cp is CP.NORM else _W_F1_DMRS_EXT
    data, dmrs, prbs = [], [], []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        prbs.append(pucch_prb(cell, cfg, ns))
        d_slot = dsy[:-1] if (shortened and slot == 1) else dsy
        wdat = _W_F1_DATA_SF3 if (shortened and slot == 1) else _W_F1_DATA
        drow, mrow = [], []
        for m, l in enumerate(d_slot):
            alpha, n_oc, n_prime = _alpha_format1(cell, cfg, ns, l)
            s_ns = np.pi / 2 if n_prime % 2 else 0.0
            w = np.exp(1j * (wdat[n_oc % 3][m] + s_ns))
            drow.append(_rseq(cell, alpha) * w)
        for m, l in enumerate(msy):
            alpha, n_oc, _ = _alpha_format1(cell, cfg, ns, l)
            w = np.exp(1j * wdm[n_oc % 3][m])
            mrow.append(_rseq(cell, alpha) * w)
        data.append(np.stack(drow).astype(np.complex64))
        dmrs.append(np.stack(mrow).astype(np.complex64))
    return data, dmrs, prbs


@functools.lru_cache(maxsize=None)
def _format2_tables(cell: Cell, cfg_key: tuple, sf_idx: int):
    """(data_seq [2,5,12], dmrs_seq [2,2,12], prb [2])."""
    cfg = PucchConfig(*cfg_key)
    dsy, msy = f2_syms(cell.cp)
    data, dmrs, prbs = [], [], []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        prbs.append(pucch_prb(cell, cfg, ns))
        data.append(np.stack([_rseq(cell, _alpha_format2(cell, cfg, ns, l))
                              for l in dsy]))
        dmrs.append(np.stack([_rseq(cell, _alpha_format2(cell, cfg, ns, l))
                              for l in msy]))
    return np.stack(data).astype(np.complex64), np.stack(dmrs).astype(np.complex64), prbs


def _f2_scramble_signed(cell: Cell, rnti: int, sf_idx: int,
                        n: int = 20) -> np.ndarray:
    c_init = ((sf_idx + 1) * (2 * cell.id + 1) << 16) + rnti
    return 1.0 - 2.0 * gold_sequence(c_init, n).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _format3_tables(cell: Cell, cfg_key: tuple, sf_idx: int,
                    shortened: bool = False):
    """(enc [2 slots][N_sf, 12, 12], dmrs [2][N_rs, 12], prb [2]).

    enc[slot][m] maps the slot's 12 QPSK symbols d -> the 12 REs of data
    SC-FDMA symbol m:  z_k = h_m / sqrt(12) * sum_j e^{-j2pi((j-ncs)%12)k/12} d_j
    (spreading weight + phase ramp + cyclic shift + DFT precode folded into
    one matrix; unitary up to the |h_m| = 1 factor).

    `shortened`: slot 1 drops the last symbol and spreads with the length-4
    Walsh OCC (pucch.c pucch3_w_n_oc_4, n_oc scaled by N_sf/5).
    """
    cfg = PucchConfig(*cfg_key)
    ncs_tab = n_cs_cell(cell)
    dsy, msy = f2_syms(cell.cp)
    k = np.arange(NRE)
    dft = np.exp(-2j * np.pi * np.outer(k, k) / NRE) / np.sqrt(NRE)
    enc, dmrs, prbs = [], [], []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        prbs.append(pucch_prb(cell, cfg, ns))
        short_slot = shortened and slot == 1
        d_slot = dsy[:-1] if short_slot else dsy
        n_sf = len(d_slot)
        if slot == 0:
            n_oc = cfg.n_pucch % 5
        else:
            n_oc = (3 * cfg.n_pucch) % 5
            if short_slot:  # map the length-5 index onto the Walsh-4 set
                n_oc = n_oc % 4
        mats = []
        for m, l in enumerate(d_slot):
            ncs = int(ncs_tab[ns, l])
            if short_slot:
                # Walsh-4 rows are real ±1: phase = pi * popcount pattern
                walsh = np.array([[1, 1, 1, 1], [1, -1, 1, -1],
                                  [1, 1, -1, -1], [1, -1, -1, 1]])
                h = (walsh[n_oc][m]
                     * np.exp(1j * np.pi * (ncs // 64) / 2))
            else:
                h = (np.exp(2j * np.pi * n_oc * m / 5)
                     * np.exp(1j * np.pi * (ncs // 64) / 2))
            # column j of the precode DFT picks input index (j - ncs) % 12
            mats.append(h * dft[:, (k - ncs) % NRE])
        enc.append(np.stack(mats).astype(np.complex64))
        dmrs.append(np.stack([_rseq(cell, _alpha_format2(cell, cfg, ns, l))
                              for l in msy]).astype(np.complex64))
    return enc, dmrs, prbs


def _d_ack(bits: tuple) -> complex:
    """1a/1b/2a/2b ACK modulation (uci.c uci_encode_format1a/b)."""
    if len(bits) == 0:
        return 1.0 + 0j
    if len(bits) == 1:
        return -1.0 + 0j if bits[0] else 1.0 + 0j
    return {(0, 0): 1, (0, 1): -1j, (1, 0): 1j, (1, 1): -1}[tuple(bits)] + 0j


# 36.211 table 5.4.1-1 / 5.4.2-1: b(0)b(1) = 00, 01, 10, 11
_QPSK_ACK = np.array([1, -1j, 1j, -1], np.complex64)


def _host_bits(bits) -> np.ndarray:
    """Payload bits (a tuple, or an array or tensor [..., n]) as uint8 numpy."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    return np.asarray(bits, np.uint8)


def _d_ack_t(bits: np.ndarray, device) -> torch.Tensor:
    """`_d_ack` of each payload in bits [..., n] -> complex64 [...]."""
    n = bits.shape[-1]
    if n == 0:
        return torch.ones(bits.shape[:-1], dtype=torch.complex64, device=device)
    if n == 1:
        idx = 3 * bits[..., 0].astype(np.int64)  # 0 -> +1, 1 -> -1
    else:
        idx = 2 * bits[..., 0].astype(np.int64) + bits[..., 1]
    cands = table("pucch_qpsk_ack", device, lambda: _QPSK_ACK)
    return cands[torch.as_tensor(idx, device=device)]


@dataclass(frozen=True)
class Pucch:
    """PUCCH processor for one (cell, config, sf_idx, rnti) bucket."""

    cell: Cell
    cfg: PucchConfig
    sf_idx: int
    rnti: int = 0
    # SRS-colliding (cell-specific SRS subframe): slot 1 is shortened by one
    # symbol for formats 1/1a/1b/3 (36.211 §5.4.1, pucch.c get_N_sf)
    shortened: bool = False

    def __post_init__(self):
        if self.cell.cp is CP.EXT and self.cfg.fmt in ("2a", "2b"):
            raise ValueError("formats 2a/2b are not defined for extended CP")
        if self.shortened and not (self.cfg.is_format1 or self.cfg.fmt == "3"):
            raise ValueError("shortened subframes apply to formats 1*/3 only")

    @property
    def _key(self):
        c = self.cfg
        return (c.fmt, c.n_pucch, c.delta_shift, c.n_cs_1, c.n_rb_2)

    @functools.cached_property
    def _host_tables(self):
        """(data per slot, DMRS per slot, PRB per slot, data symbols per
        slot, DMRS symbols): data is the format's spreading (formats 1*:
        [N_sf, 12]; 2*: [5, 12]; 3: the [N_sf, 12, 12] encoder)."""
        cp = self.cell.cp
        if self.cfg.is_format1:
            data, dmrs, prbs = _format1_tables(self.cell, self._key, self.sf_idx,
                                               self.shortened)
            dsy, msy = f1_syms(cp)
        elif self.cfg.fmt == "3":
            data, dmrs, prbs = _format3_tables(self.cell, self._key, self.sf_idx,
                                               self.shortened)
            dsy, msy = f2_syms(cp)
        else:
            data, dmrs, prbs = _format2_tables(self.cell, self._key, self.sf_idx)
            dsy, msy = f2_syms(cp)
        syms = tuple(dsy[:-1] if (self.shortened and slot == 1) else dsy
                     for slot in range(2))
        return list(data), list(dmrs), prbs, syms, msy

    def _slot_idx(self, slot: int, syms) -> np.ndarray:
        """Flat grid indices [len(syms), 12] of the slot's PRB at `syms`."""
        o = self.cell.ofdm
        k0 = self._host_tables[2][slot] * NRE
        ls = np.asarray(syms) + slot * o.nsymb_slot
        return (ls[:, None] * o.nof_re + k0 + np.arange(NRE)[None, :]).astype(np.int64)

    def re_indices(self) -> np.ndarray:
        """Flat grid indices (symbol * nof_re + subcarrier) of every RE this
        PUCCH occupies, data and DMRS, in both slots."""
        _, _, _, syms, msy = self._host_tables
        return np.concatenate([self._slot_idx(s, ls).ravel()
                               for s in range(2) for ls in (syms[s], msy)])

    def _tables(self, device):
        """Per slot: (data, DMRS, data RE indices, DMRS RE indices) on the
        device, uploaded once per bucket."""
        data, dmrs, _, syms, msy = self._host_tables
        key = ("pucch", self.cell, self._key, self.sf_idx, self.shortened)
        t = lambda name, build: table(key + (name,), device, build)
        return [(t(("data", s), lambda s=s: data[s]), t(("dmrs", s), lambda s=s: dmrs[s]),
                 t(("re_data", s), lambda s=s: self._slot_idx(s, syms[s])),
                 t(("re_dmrs", s), lambda s=s: self._slot_idx(s, msy)))
                for s in range(2)]

    def _scramble(self, n: int, device) -> torch.Tensor:
        # the format 2/3 scrambling seed carries the RNTI: a per-UE table
        return sequence(("pucch_scr", self.cell.id, self.rnti, self.sf_idx, n), device,
                        lambda: _f2_scramble_signed(self.cell, self.rnti, self.sf_idx, n))

    # -- UE side --------------------------------------------------------------
    def encode(self, ack_bits=(), cqi_bits=(), grid=None, device=None):
        """Encode into an UL grid [..., nsymb_sf, nof_re] (a new tensor).

        The payloads are a tuple of bits, as in the JAX package, or arrays
        [..., n] with one payload per subframe of the batch.  Without `grid`
        the REs outside this PUCCH are zero.
        """
        o = self.cell.ofdm
        dev = as_tensor(grid, device).device if grid is not None else resolve(device)
        ack, cqi = _host_bits(ack_bits), _host_bits(cqi_bits)
        tabs = self._tables(dev)
        if self.cfg.is_format1:
            d0 = _d_ack_t(ack, dev)
            dvals = [data * d0[..., None, None] for data, _, _, _ in tabs]
            mvals = [dmrs for _, dmrs, _, _ in tabs]
        elif self.cfg.fmt == "3":
            cw = block_encode(ack, 48)
            s = _f2_scramble_signed(self.cell, self.rnti, self.sf_idx, 48)
            sym = modulate(as_tensor(cw ^ (s < 0).astype(np.uint8), dev), Modulation.QPSK)
            d = sym.reshape(sym.shape[:-1] + (2, NRE))  # slot 0 / slot 1 blocks
            dvals = [torch.einsum("mkj,...j->...mk", enc, d[..., s_, :])
                     for s_, (enc, _, _, _) in enumerate(tabs)]
            mvals = [dmrs for _, dmrs, _, _ in tabs]
        else:
            # (20, A) Reed-Muller code of each payload (rm20_encode, batched)
            cw = (cqi @ _RM20_BASIS[:, : cqi.shape[-1]].T) % 2
            s = _f2_scramble_signed(self.cell, self.rnti, self.sf_idx)
            sym = modulate(as_tensor(cw ^ (s < 0).astype(np.uint8), dev), Modulation.QPSK)
            sym = sym.reshape(sym.shape[:-1] + (2, -1))
            dvals = [data * sym[..., s_, :, None] for s_, (data, _, _, _) in enumerate(tabs)]
            mvals = [dmrs for _, dmrs, _, _ in tabs]
            if self.cfg.nof_ack_bits:
                # 2a/2b: second DMRS symbol carries the ACK (normal CP only)
                d_ack = _d_ack_t(ack, dev)
                scale = torch.stack([torch.ones_like(d_ack), d_ack], dim=-1)
                mvals = [m * scale[..., :, None] for m in mvals]
        batch = torch.broadcast_shapes(*(v.shape[:-2] for v in dvals + mvals))
        if grid is None:
            flat = torch.zeros(batch + (o.nsymb_sf * o.nof_re,), dtype=torch.complex64,
                               device=dev)
        else:
            grid = as_tensor(grid, dev).to(torch.complex64)
            batch = torch.broadcast_shapes(batch, grid.shape[:-2])
            flat = grid.expand(batch + grid.shape[-2:]).reshape(
                batch + (o.nsymb_sf * o.nof_re,)).clone()
        for (_, _, re_d, re_m), dv, mv in zip(tabs, dvals, mvals):
            flat[..., re_d] = dv
            flat[..., re_m] = mv
        return flat.reshape(batch + (o.nsymb_sf, o.nof_re))

    # -- eNB side -------------------------------------------------------------
    def decode(self, grid, nof_cqi_bits: int = 0, nof_ack3_bits: int = 0, device=None):
        """-> dict with detected bits and metrics.

        Format 1: {'detected', 'metric'}.  Format 1a/1b: {'ack': [n] bits,
        'metric': correlation magnitude}.
        Format 2/2a/2b: {'cqi': [A] bits, 'ack': [...], 'metric': ...}.
        Format 3: {'ack': [nof_ack3_bits] bits, 'metric'} — the expected
        ACK+SR payload size must be passed in (as the reference's
        uci_cfg does).
        DMRS-based MRC per slot, despread by products (batched over grid dims).
        """
        grid = as_tensor(grid, device)
        o = self.cell.ofdm
        flat = grid.reshape(grid.shape[:-2] + (o.nsymb_sf * o.nof_re,))
        tabs = self._tables(grid.device)
        res = [(flat[..., re_d], flat[..., re_m]) for _, _, re_d, re_m in tabs]

        if self.cfg.is_format1:
            corr, energy = 0.0, 0.0
            for (data, dmrs, _, _), (y_d, y_m) in zip(tabs, res):
                h = torch.mean(y_m * torch.conj(dmrs), dim=(-1, -2))
                z = torch.mean(y_d * torch.conj(data), dim=(-1, -2))
                corr = corr + z * torch.conj(h)
                energy = energy + torch.abs(h) ** 2
            d0 = corr / torch.clamp(energy, min=1e-12)
            metric = torch.abs(d0)
            nb = self.cfg.nof_ack_bits
            if nb == 0:
                return {"detected": metric > 0.5, "metric": metric}
            if nb == 1:
                return {"ack": (d0.real < 0)[..., None].to(torch.uint8), "metric": metric}
            return {"ack": self._qpsk_ack(d0), "metric": metric}

        if self.cfg.fmt == "3":
            ds = []
            for (enc, dmrs, _, _), (y_d, y_m) in zip(tabs, res):
                h = torch.mean(y_m * torch.conj(dmrs), dim=(-1, -2))
                # enc is unitary per symbol: despread is the adjoint
                d = torch.einsum("mkj,...mk->...j", torch.conj(enc), y_d) / enc.shape[0]
                ds.append(d * torch.conj(h)[..., None])
            q = torch.cat(ds, dim=-1)  # [..., 24] QPSK estimates
            llr = demod_soft(q, Modulation.QPSK) * self._scramble(48, grid.device)
            bits, metric = block_decode(llr, nof_ack3_bits)
            return {"ack": bits,
                    "metric": metric / torch.clamp(torch.sum(torch.abs(llr), -1), min=1e-9)}

        zs, hs = [], []
        for (data, dmrs, _, _), (y_d, y_m) in zip(tabs, res):
            h_sym = y_m * torch.conj(dmrs)  # [..., n_rs, 12]
            h = torch.mean(h_sym[..., 0, :], dim=-1)  # first DMRS: always clean
            z = torch.mean(y_d * torch.conj(data), dim=-1)
            zs.append(z * torch.conj(h)[..., None])
            hs.append(h_sym)
        q = torch.cat(zs, dim=-1)  # [..., 10] QPSK estimates
        llr = demod_soft(q, Modulation.QPSK) * self._scramble(20, grid.device)
        out = {}
        if nof_cqi_bits:
            cb = table(("pucch_rm20", nof_cqi_bits), grid.device,
                       lambda: _rm20_codebook(nof_cqi_bits))
            sc = -(llr @ cb.T)
            best = torch.argmax(sc, dim=-1)
            shifts = torch.arange(nof_cqi_bits, device=grid.device)
            out["cqi"] = ((best[..., None] >> shifts) & 1).to(torch.uint8)
            out["metric"] = (torch.gather(sc, -1, best[..., None])[..., 0]
                             / torch.clamp(torch.sum(torch.abs(llr), -1), min=1e-9))
        nb = self.cfg.nof_ack_bits
        if nb:
            # ACK rides on the 2nd DMRS symbol of each slot: d10 = h2 / h1
            num = 0.0
            for h_sym in hs:
                num = num + torch.mean(h_sym[..., 1, :], dim=-1) * torch.conj(
                    torch.mean(h_sym[..., 0, :], dim=-1))
            if nb == 1:
                out["ack"] = (num.real < 0)[..., None].to(torch.uint8)
            else:
                out["ack"] = self._qpsk_ack(num / torch.clamp(torch.abs(num), min=1e-12))
        return out

    @staticmethod
    def _qpsk_ack(d):
        """Nearest of the four ACK points (the first on a tie) -> bits [..., 2]."""
        cands = table("pucch_qpsk_ack", d.device, lambda: _QPSK_ACK)
        best = torch.argmin(torch.abs(d[..., None] - cands), dim=-1)
        return torch.stack([(best >> 1) & 1, best & 1], dim=-1).to(torch.uint8)
