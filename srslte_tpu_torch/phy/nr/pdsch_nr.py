"""NR PDSCH processor, 1-2 layers / type-1 and type-2 DMRS (38.211 §7.3.1,
pdsch_nr.c).

Reference behavior: lib/src/phy/phch/pdsch_nr.c — NR DL-SCH (LDPC) coding,
scrambling c_init = rnti*2^15 + n_ID, modulation up to 256QAM, mapping over
the 14-symbol slot grid skipping the DMRS symbol(s); decode with DMRS LS
channel estimation + equalization.  n_layers=2 adds the single-codeword
layer map (srsran_layermap_nr, layermap.c:229), DMRS ports 1000/1001
separated by the type-1 fd-OCC within CDM group 0 (dmrs_sch.c), and a
2x2 per-RE MMSE detector on the RX side.

Full-slot or grant allocation per (carrier, n_prb, mcs) bucket; the RE map,
the pilots and the interpolation plan are device tables keyed by the
allocation (never by the RNTI).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ...utils.jit import lazy_jit
from ..common.scrambling import scramble_bits, scramble_llr
from ..mimo import equalize_zf, mmse_2x2
from ..modem.modem import Modulation, demod_soft, modulate
from .dlsch_nr import NrDlschConfig, nr_cbsegm, nr_dlsch_decode, nr_dlsch_encode
from .dmrs import dmrs_subcarriers, dmrs_symbols, dmrs_values
from .params import NSYMB_SLOT, NrCarrier
from .ra_nr import NrGrant

DMRS_SYMBOL = 2  # PDSCH mapping type A, single-symbol DMRS at l=2


def pdsch_nr_cinit(rnti: int, n_id: int, q: int = 0) -> int:
    return ((rnti << 15) + (q << 14) + n_id) % (1 << 31)


@dataclass(frozen=True)
class NrPdsch:
    """Two operating modes: full-slot (legacy mcs_qm/rate fields) or
    grant-based (`grant` set: PRB range + symbol span + 38.214 MCS/TBS,
    as signaled by DCI 1_0 — ra_nr.c srsran_ra_nr_fill_tb)."""

    carrier: NrCarrier
    mcs_qm: int = 6  # modulation order (2/4/6/8), legacy full-slot mode
    rate: float = 0.5  # target code rate -> TBS = rate * available bits
    rnti: int = 0x4601
    slot: int = 0
    grant: "NrGrant | None" = None
    dmrs_type: int = 1  # 38.211 configuration type 1 (comb) or 2 (pairs)
    dmrs_add_pos: int = 0  # dmrs-AdditionalPosition (table 7.4.1.1.2-3)
    n_layers: int = 1  # 1 (port dim absent) or 2 (ports 1000/1001, type 1)

    @property
    def modulation(self) -> Modulation:
        if self.grant is not None:
            return self.grant.modulation
        return {2: Modulation.QPSK, 4: Modulation.QAM16, 6: Modulation.QAM64,
                8: Modulation.QAM256}[self.mcs_qm]

    @property
    def _qm(self) -> int:
        return self.grant.qm if self.grant is not None else self.mcs_qm

    @property
    def _nl(self) -> int:
        return self.grant.n_layers if self.grant is not None else self.n_layers

    @property
    def _sc_range(self) -> tuple[int, int]:
        if self.grant is None:
            return 0, self.carrier.nof_re
        g = self.grant
        return g.prb_start * 12, (g.prb_start + g.n_prb) * 12

    @property
    def _dmrs_syms(self) -> tuple[int, ...]:
        return dmrs_symbols(self.dmrs_add_pos)

    @property
    def _symbols(self) -> list[int]:
        dm = set(self._dmrs_syms)
        if self.grant is None:
            return [l for l in range(NSYMB_SLOT) if l not in dm]
        g = self.grant
        return [l for l in range(g.start_sym, g.start_sym + g.n_sym)
                if l not in dm]

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        """Data RE indices over the slot grid [NSYMB_SLOT, nof_re]."""
        nre = self.carrier.nof_re
        k0, k1 = self._sc_range
        idx = [l * nre + np.arange(k0, k1) for l in self._symbols]
        return np.concatenate(idx).astype(np.int32)

    @functools.cached_property
    def cfg(self) -> NrDlschConfig:
        g = len(self.re_idx) * self._qm * self._nl
        if self.grant is not None:
            return NrDlschConfig(tbs=self.grant.tbs, G=g, Qm=self._qm,
                                 rate=self.grant.rate, rv=self.grant.rv)
        tbs = int(g * self.rate) // 8 * 8  # simplified 38.214 TBS quantize
        # 38.214 TBS values make B divisible by C; our simplified quantizer
        # walks down until the segmentation divides evenly
        while tbs > 8:
            seg = nr_cbsegm(tbs, self.rate)
            if (tbs + seg.tb_crc_len) % seg.C == 0:
                break
            tbs -= 8
        return NrDlschConfig(tbs=tbs, G=g, Qm=self.mcs_qm, rate=self.rate)

    @property
    def tbs(self) -> int:
        return self.cfg.tbs

    @property
    def cinit(self) -> int:
        return pdsch_nr_cinit(self.rnti, self.carrier.n_id)

    def _table(self, name: str, device, build) -> torch.Tensor:
        """A device table of this allocation (not of the UE: the RNTI and
        the MCS are not in the key)."""
        key = ("nr_pdsch", name, self.carrier, self.slot, self._sc_range,
               tuple(self._symbols), self.dmrs_type, self.dmrs_add_pos)
        return table(key, device, build)

    def _re_idx_t(self, device) -> torch.Tensor:
        return self._table("re_idx", device, lambda: self.re_idx.astype(np.int64))

    def _dmrs_t(self, l: int, device):
        """`_dmrs(l)` on the device: (positions int64, port-1000 values,
        port-1001 values)."""
        ks = self._table(("dmrs_k", l), device, lambda: self._dmrs(l)[0].astype(np.int64))
        pil = self._table(("dmrs_pil", l), device, lambda: self._dmrs(l)[1])
        occ = self._table(("dmrs_occ", l), device,
                          lambda: (self._dmrs(l)[1] * self._dmrs(l)[2]).astype(np.complex64))
        return ks, pil, occ

    def _plan_t(self, name: str, device):
        """An interpolation plan (left, right, t) on the device."""
        plan = getattr(self, name)
        return tuple(self._table((name, i), device,
                                 lambda i=i: plan[i].astype(np.int64) if i < 2 else plan[i])
                     for i in range(3))

    # -- gNB side -------------------------------------------------------------
    @lazy_jit(static_argnums=(0,))
    def encode(self, bits, device=None):
        """bits [..., tbs] -> slot grid complex64: [..., NSYMB_SLOT, nof_re]
        single layer, or [..., 2, NSYMB_SLOT, nof_re] per-port for 2 layers
        (ports 1000/1001, identity precoding)."""
        bits = as_tensor(bits, device)
        dev = bits.device
        lead = bits.shape[:-1]
        nre = self.carrier.nof_re
        coded = nr_dlsch_encode(bits, self.cfg)
        scr = scramble_bits(coded, self.cinit)
        sym = modulate(scr, self.modulation)
        idx = self._re_idx_t(dev)
        if self._nl == 1:
            grid = torch.zeros(lead + (NSYMB_SLOT * nre,), dtype=torch.complex64, device=dev)
            grid[..., idx] = sym
            grid = grid.reshape(lead + (NSYMB_SLOT, nre))
            for l in self._dmrs_syms:
                ks, pil, _ = self._dmrs_t(l, dev)
                grid[..., l, ks] = pil
            return grid
        # single-codeword layer map x_l(j) = d(2j + l) (layermap.c:229)
        x = sym.reshape(sym.shape[:-1] + (-1, 2)).transpose(-1, -2)  # [..., 2, n_re]
        grid = torch.zeros(lead + (2, NSYMB_SLOT * nre), dtype=torch.complex64, device=dev)
        grid[..., idx] = x
        grid = grid.reshape(lead + (2, NSYMB_SLOT, nre))
        for l in self._dmrs_syms:
            ks, pil, occ = self._dmrs_t(l, dev)
            # both ports' pilots share the CDM-group REs; fd-OCC separates
            grid[..., 0, l, ks] = pil
            grid[..., 1, l, ks] = occ
        return grid

    def _dmrs(self, l: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(positions, port-1000 values, port-1001 fd-OCC) of symbol l.

        Both type 1 (comb) and type 2 (pairs) alternate k' = 0, 1 along the
        mapping order inside CDM group 0, so the 38.211 table 7.4.1.1.2-1/2
        w_f(k') = (+1, -1) for ports 1001/1003 is an alternating sign."""
        ks = dmrs_subcarriers(self.carrier, self.dmrs_type)
        pil = dmrs_values(self.carrier, self.slot, l, self.dmrs_type)
        occ = np.where(np.arange(len(ks)) % 2 == 0, 1.0, -1.0)
        k0, k1 = self._sc_range
        sel = (ks >= k0) & (ks < k1)
        return ks[sel], pil[sel], occ[sel].astype(np.complex64)

    @functools.cached_property
    def _interp_plan(self):
        """(left, right, t) linear-interp plan from the allocation's pilot
        subcarriers onto every allocated subcarrier (works for the type-1
        comb and type-2 pair layouts alike)."""
        ks, _, _ = self._dmrs(self._dmrs_syms[0])
        k0, k1 = self._sc_range
        return self._interp_from(ks - k0, k1 - k0)

    @staticmethod
    def _interp_from(sc: np.ndarray, n_tgt: int):
        tgt = np.arange(n_tgt)
        right = np.searchsorted(sc, tgt).clip(1, len(sc) - 1)
        left = right - 1
        denom = np.maximum(sc[right] - sc[left], 1e-6)
        t = ((tgt - sc[left]) / denom).clip(0.0, 1.0).astype(np.float32)
        return left.astype(np.int32), right.astype(np.int32), t

    @functools.cached_property
    def _interp_plan_pairs(self):
        """Interp plan from CDM pair centers (2-layer chest) onto the
        allocation subcarriers."""
        ks, _, _ = self._dmrs(self._dmrs_syms[0])
        k0, k1 = self._sc_range
        sc = (ks.reshape(-1, 2).mean(axis=1)) - k0  # pair centers
        return self._interp_from(sc, k1 - k0)

    # -- UE side --------------------------------------------------------------
    def _ls(self, grid):
        """LS at the pilots, averaged over the DMRS symbols: [..., P]."""
        ls = 0.0
        for l in self._dmrs_syms:
            ks, pil, _ = self._dmrs_t(l, grid.device)
            ls = ls + grid[..., l, ks] * torch.conj(pil)  # |pil| = 1
        return ls / len(self._dmrs_syms)

    @lazy_jit(static_argnums=(0,))
    def demod_llr(self, grid, device=None):
        """grid [..., NSYMB_SLOT, nof_re] -> (llr [..., G], noise [...]).

        The chest + equalize + demod front half of decode, exposed so the
        NR HARQ entity can IR-combine the descrambled LLRs across
        retransmissions before one decode.
        """
        grid = as_tensor(grid, device)
        if self._nl == 2:
            return self._demod_llr_2layer(grid)
        dev = grid.device
        # LS per DMRS symbol, time-averaged (additional positions improve
        # the estimate; a single symbol reduces to the old behavior)
        ls = self._ls(grid)
        # pilot set -> allocation band by linear interpolation; the plan
        # handles the type-1 comb and the type-2 pair layout alike
        left, right, t = self._plan_t("_interp_plan", dev)
        ce = ls[..., left] * (1 - t) + ls[..., right] * t
        noise = torch.mean(torch.abs(ls[..., 2:] + ls[..., :-2]
                                     - 2 * ls[..., 1:-1]) ** 2, dim=-1) / 6

        flat = grid.reshape(grid.shape[:-2] + (-1,))
        y = flat[..., self._re_idx_t(dev)]
        h = ce.repeat((1,) * (ce.ndim - 1) + (len(self._symbols),))  # same CE every data symbol
        xhat = equalize_zf(y, h)
        gain = torch.abs(h) ** 2
        w = gain / torch.clamp(noise[..., None], min=1e-9)
        llr = demod_soft(xhat, self.modulation)
        llr = llr * torch.repeat_interleave(w, self._qm, dim=-1)
        # saturate like the reference's int8/int16 LLR paths: keeps the
        # filler-bit known-zero priors (-1e4 in rm_rx) dominant at high SNR
        llr = torch.clamp(llr, -1e3, 1e3)
        return scramble_llr(llr, self.cinit), noise

    def _demod_llr_2layer(self, grid):
        """grid [..., 2rx, NSYMB_SLOT, nof_re] -> (llr [..., G], noise).

        LS at the shared CDM-group REs, fd-OCC despreading to per-port
        estimates at the pair centers, interpolation to the allocation,
        per-RE 2x2 MMSE (mimo.mmse_2x2), layer demap d(2j+l).
        """
        dev = grid.device
        ls = self._ls(grid)  # [..., 2rx, P]
        pairs = ls.reshape(ls.shape[:-1] + (-1, 2))
        h0 = (pairs[..., 0] + pairs[..., 1]) / 2  # port 1000 @ pair centers
        h1 = (pairs[..., 0] - pairs[..., 1]) / 2  # port 1001 (fd-OCC)
        left, right, t = self._plan_t("_interp_plan_pairs", dev)

        def interp(hp):
            return hp[..., left] * (1 - t) + hp[..., right] * t
        heff = torch.stack([interp(h0), interp(h1)], dim=-2)  # [.., 2rx, 2, sc]
        # noise: the OCC-despread residual beyond the two port estimates is
        # pure noise at flat-enough channels; use second differences of h0
        noise = torch.mean(torch.abs(h0[..., 2:] + h0[..., :-2]
                                     - 2 * h0[..., 1:-1]) ** 2, dim=(-2, -1)) / 6

        nsym = len(self._symbols)
        k0, k1 = self._sc_range
        nsc = k1 - k0
        flat = grid.reshape(grid.shape[:-2] + (-1,))
        y = flat[..., self._re_idx_t(dev)]  # [..., 2rx, nsym*nsc]
        y = y.reshape(y.shape[:-1] + (nsym, nsc)).movedim(-2, -3)  # [..., nsym, 2rx, nsc]
        hb = heff[..., None, :, :, :].expand(heff.shape[:-3] + (nsym,) + heff.shape[-3:])
        xhat, gain = mmse_2x2(y, hb, noise)  # [..., nsym, 2, nsc]
        # layer demap to codeword order d(2j + l), j symbol-major
        xs = xhat.movedim(-2, -1).reshape(xhat.shape[:-3] + (nsym * nsc * 2,))
        gs = gain.movedim(-2, -1).reshape(xs.shape)
        llr = demod_soft(xs, self.modulation)
        w = gs / torch.clamp(noise[..., None], min=1e-9)
        llr = llr * torch.repeat_interleave(w, self._qm, dim=-1)
        llr = torch.clamp(llr, -1e3, 1e3)
        return scramble_llr(llr, self.cinit), noise

    @lazy_jit(static_argnums=(0,), static_argnames=("n_iter",))
    def decode(self, grid, n_iter: int = 10, device=None):
        """grid [..., NSYMB_SLOT, nof_re] (single layer) or
        [..., 2rx, NSYMB_SLOT, nof_re] (2 layers) -> (bits, ok, info).

        LS estimate at the DMRS symbols, linear interpolation across the
        pilot set, constant extrapolation in time, ZF (1 layer) or 2x2
        MMSE (2 layers) equalization.
        """
        llr, noise = self.demod_llr(grid, device)
        bits, ok = nr_dlsch_decode(llr, self.cfg, n_iter=n_iter)
        return bits, ok, {"noise": noise}
