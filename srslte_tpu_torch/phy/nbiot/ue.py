"""NB-IoT high-level UE objects: sync, cell search, MIB, DL receive chain.

Reference behavior: lib/src/phy/ue/{ue_sync_nbiot.c, ue_cell_search_nbiot.c,
ue_mib_nbiot.c, ue_dl_nbiot.c} and lib/src/phy/sync/sync_nbiot.c — the
FIND->TRACK sample alignment at 1.92 Msps, NPSS-based timing + CFO, NSSS
cell-id/frame-position detection, the NPBCH decode loop over the 64-frame
period, and the per-subframe NRS chest + NPDCCH/NPDSCH decode front end
(plus the eNB-side composition mirroring lib/examples/npdsch_enodeb.c).

The standalone NB-IoT carrier rides the 6-PRB/128-FFT OFDM modem (1.92
Msps).  The NB-IoT PRB occupies REs 36..47 of the 72-RE host grid — FFT
bins 1..12, the same convention as the NPSS replica in sync.py (subcarrier
k -> bin k+1).  NPSS search is one FFT correlation, NSSS one [2016, 132]
product, NPBCH one blind 16-hypothesis Viterbi launch, and chest is a
closed-form LS over the 8 NRS pilots (flat 180-kHz channel).  The eNB
composes a frame from one host table of its NPSS, NSSS and NRS, scattered
onto the device once per frame.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, resolve, table
from ..common.params import OfdmParams
from ..ofdm import Ofdm
from .npbch import MibNb, Npbch
from .npdcch import Npdcch
from .npdsch import NbDlGrant, Npdsch
from .nrs import NRS_SYMBOLS, nrs_subcarriers, nrs_values
from .sync import npss_find, npss_sequence, npss_time, nsss_find, nsss_sequence

HOST_PRB = 6  # host numerology: 1.92 Msps, FFT 128
NB_RE0 = 36  # first RE of the NB-IoT PRB inside the 72-RE host grid
SYNC_SYMBOLS = tuple(range(3, 14))  # NPSS/NSSS symbols within the subframe


@functools.lru_cache(maxsize=1)
def nsss_re_order() -> np.ndarray:
    """Flat [132] grid indices of NSSS d(0..131): subcarrier-first over
    symbols 3..13 (36.211 section 10.2.7.2.2)."""
    return np.concatenate(
        [l * 12 + np.arange(12) for l in SYNC_SYMBOLS]).astype(np.int32)


@dataclass(frozen=True)
class NbOfdm:
    """Standalone NB-IoT carrier modem over the 6-PRB host numerology."""

    @functools.cached_property
    def host(self) -> Ofdm:
        return Ofdm(OfdmParams(HOST_PRB))

    @property
    def params(self) -> OfdmParams:
        return self.host.params

    @property
    def sf_len(self) -> int:
        return self.params.sf_len  # 1920 samples per subframe

    def tx_sf(self, nb_grid, device=None):
        """NB grid [..., 14, 12] -> samples [..., 1920]."""
        nb_grid = as_tensor(nb_grid, device)
        g = torch.zeros(nb_grid.shape[:-1] + (self.params.nof_re,), dtype=torch.complex64,
                        device=nb_grid.device)
        g[..., NB_RE0 : NB_RE0 + 12] = nb_grid
        return self.host.tx_sf(g)

    def rx_sf(self, samples, device=None):
        """Samples [..., 1920] -> NB grid [..., 14, 12]."""
        return self.host.rx_sf(samples, device)[..., NB_RE0 : NB_RE0 + 12]

    @functools.cached_property
    def npss_offset(self) -> int:
        """Sample offset of NPSS (symbol 3) within its subframe."""
        cps = self.params.cp_lens_slot()
        return sum(cps[i] + self.params.symbol_sz for i in range(3))


# ---------------------------------------------------------------------------
# channel estimation (NRS LS, flat narrowband model)
# ---------------------------------------------------------------------------

def _nrs_flat(n_id: int, port: int) -> np.ndarray:
    """[8] flat 14x12-grid indices of one port's NRS pilots."""
    sym = np.repeat(np.asarray(NRS_SYMBOLS), 2)
    return (sym * 12 + nrs_subcarriers(n_id, port).reshape(-1)).astype(np.int64)


def nb_chest(grid, n_id: int, sf_idx: int, device=None):
    """NRS LS estimate -> (ce [2, 14, 12], noise_var scalar).

    grid [..., 14, 12].  The 180-kHz carrier is frequency-flat within any
    3GPP delay spread, so the estimate is the pilot mean per port
    (chest_dl_nbiot's averaging limit); noise is the pilot residual
    variance on port 0.  An absent port 1 yields ce[1] ~ 0, which the
    NPBCH port hypothesis test rejects naturally.
    """
    grid = as_tensor(grid, device)
    dev = grid.device
    flat = grid.reshape(grid.shape[:-2] + (-1,))
    vals = table(("nrs_conj", n_id, sf_idx), dev,
                 lambda: np.conj(nrs_values(n_id, sf_idx).reshape(-1)))
    ce_ports = []
    resid = None
    for p in range(2):
        y = flat[..., table(("nrs_flat", n_id, p), dev, lambda p=p: _nrs_flat(n_id, p))]
        ls = y * vals
        h = torch.mean(ls, dim=-1)
        if p == 0:
            resid = torch.mean(torch.abs(ls - h[..., None]) ** 2, dim=-1)
        ce_ports.append(h[..., None, None].expand(h.shape + (14, 12)))
    return torch.stack(ce_ports, dim=-3), resid


# ---------------------------------------------------------------------------
# eNB-side frame composition (npdsch_enodeb.c analog)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NbEnbDl:
    """Standalone NB-IoT downlink frame composer (1 or 2 NRS ports)."""

    n_id: int
    nof_ports: int = 1

    @functools.cached_property
    def ofdm(self) -> NbOfdm:
        return NbOfdm()

    @functools.cached_property
    def npbch(self) -> Npbch:
        return Npbch(self.n_id, self.nof_ports)

    def _nrs_rows(self, sf_idx: int) -> np.ndarray:
        """[2, 14, 12] grid with this subframe's NRS on the ports sent."""
        g = np.zeros((2, 14 * 12), np.complex64)
        vals = nrs_values(self.n_id, sf_idx).reshape(-1)
        for p in range(self.nof_ports):
            g[p, _nrs_flat(self.n_id, p)] = vals
        return g.reshape(2, 14, 12)

    def _put_nrs(self, grid, sf_idx: int, device=None):
        grid = as_tensor(grid, device)
        nrs = table(("nb_nrs", self.n_id, self.nof_ports, sf_idx), grid.device,
                    lambda: self._nrs_rows(sf_idx))
        mask = nrs != 0
        return torch.where(mask, nrs, grid)

    def _frame_table(self, nf: int) -> np.ndarray:
        """[10, 2, 14, 12] NPSS, NSSS and NRS of frame nf (they repeat
        every 8 frames)."""
        g = np.zeros((10, 2, 14, 12), np.complex64)
        seq = npss_sequence()
        for sf_idx in range(10):
            if sf_idx == 5:
                for i, l in enumerate(SYNC_SYMBOLS):
                    g[5, 0, l, 0:11] = seq[i]
            elif sf_idx == 9 and nf % 2 == 0:
                g[9, 0].reshape(-1)[nsss_re_order()] = nsss_sequence(self.n_id, (nf // 2) % 4)
            else:
                g[sf_idx] = self._nrs_rows(sf_idx)
        return g

    def frame_grids(self, mib: MibNb, nf: int, data: dict | None = None, device=None):
        """One radio frame -> grids [10, 2, 14, 12].

        data: optional {sf_idx: encoder} where encoder(grids[sf]) writes a
        pre-encoded NPDCCH/NPDSCH subframe (sf_idx not in {0, 5, 9}).
        """
        dev = resolve(device)
        grids = table(("nb_frame", self.n_id, self.nof_ports, nf % 8), dev,
                      lambda: self._frame_table(nf)).clone()
        grids[0] = self.npbch.encode_frame(mib, nf, grids[0])
        for sf_idx in sorted(data or ()):
            if sf_idx in (0, 5) or (sf_idx == 9 and nf % 2 == 0):
                continue
            grids[sf_idx] = data[sf_idx](grids[sf_idx])
        return grids

    def frame_signal(self, mib: MibNb, nf: int, data: dict | None = None, device=None):
        """One radio frame -> port-0 time samples [19200]."""
        grids = self.frame_grids(mib, nf, data, device)
        s = self.ofdm.tx_sf(grids)  # [10, 2, 1920]
        return s[:, : self.nof_ports].sum(dim=1).reshape(-1)


# ---------------------------------------------------------------------------
# UE-side objects
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class UeSyncNbiot:
    """NPSS-based sample alignment: FIND over a capture, TRACK per frame."""

    @functools.cached_property
    def ofdm(self) -> NbOfdm:
        return NbOfdm()

    def find(self, samples, device=None):
        """samples [n] -> (sf0_offset, cfo_hz, metric).

        Locates the strongest NPSS (subframe 5, symbols 3..13) and derives
        the offset of the *next* subframe-0 boundary at or after 0.
        """
        samples = as_tensor(samples, device)
        off, metric = npss_find(samples)
        off = int(off)
        cfo = self.cfo_from_npss(samples, off)
        sf_len = self.ofdm.sf_len
        # earliest equivalent frame boundary (the detected peak may be any
        # of the capture's NPSS repetitions)
        sf0 = (off - self.ofdm.npss_offset - 5 * sf_len) % (10 * sf_len)
        return sf0, float(cfo), float(metric)

    def cfo_from_npss(self, samples, off: int, device=None):
        """CFO (Hz) from per-symbol NPSS correlation phase increments."""
        samples = as_tensor(samples, device)
        p = self.ofdm.params
        rep_np = npss_time(p.symbol_sz)
        rep = table(("npss_time", p.symbol_sz), samples.device, lambda: rep_np)
        r = samples[off : off + len(rep_np)]
        cps = (p.cp_lens_slot() * 2)[3:14]
        prods = []
        pos = 0
        for cp in cps:
            n = cp + p.symbol_sz
            prods.append(torch.sum(torch.conj(rep[pos : pos + n]) * r[pos : pos + n]))
            pos += n
        prods = torch.stack(prods)
        rot = torch.sum(prods[1:] * torch.conj(prods[:-1]))
        d = len(rep_np) / (len(cps) - 1)  # mean symbol spacing in samples
        return torch.angle(rot) * p.srate / (2 * np.pi * d)

    def track(self, samples, expected_npss: int, window: int = 8, device=None):
        """Re-correlate around the expected NPSS position -> offset delta."""
        samples = as_tensor(samples, device)
        rep = npss_time(self.ofdm.params.symbol_sz)
        lo = max(expected_npss - window, 0)
        seg = samples[lo : expected_npss + window + len(rep)]
        off, metric = npss_find(seg)
        return int(off) + lo - expected_npss, float(metric)


def cfo_correct(samples, cfo_hz: float, srate: int = 1920000, device=None):
    """samples [..., n] times exp(-j 2 pi cfo_hz / srate * n): the phase in
    float32, a float32 constant times a float32 ramp, as the reference
    forms it."""
    samples = as_tensor(samples, device)
    n = torch.arange(samples.shape[-1], dtype=torch.float32, device=samples.device)
    ph = n * float(np.float32(-2.0 * math.pi * cfo_hz / srate))
    return samples * torch.exp(1j * ph)


@dataclass(frozen=True)
class UeCellSearchNbiot:
    """NPSS timing + NSSS identity scan (ue_cell_search_nbiot.c analog)."""

    @functools.cached_property
    def ofdm(self) -> NbOfdm:
        return NbOfdm()

    def search(self, samples, device=None):
        """samples [>= 40 ms] -> dict(n_id, frame_pos, sf0_offset, cfo_hz).

        NPSS fixes 10-ms timing; the two 10-ms NSSS hypotheses (subframe 9
        of even frames) are both correlated and the stronger wins, yielding
        n_id and nf/2 mod 4.  sf0_offset points at an even frame boundary.
        """
        samples = as_tensor(samples, device)
        sync = UeSyncNbiot()
        sf0, cfo, metric = sync.find(samples)
        x = cfo_correct(samples, cfo)
        sf_len = self.ofdm.sf_len
        order = table("nsss_re_order", x.device, lambda: nsss_re_order().astype(np.int64))
        best = None
        for hyp in range(2):
            start = sf0 + hyp * 10 * sf_len + 9 * sf_len
            if start + sf_len > x.shape[-1]:
                continue
            grid = self.ofdm.rx_sf(x[start : start + sf_len])
            d = grid.reshape(-1)[order]
            nid, fpos, m = nsss_find(d)
            host = torch.stack([nid.to(torch.float64), fpos.to(torch.float64),
                                m.to(torch.float64)]).cpu().numpy()
            m = float(host[2])
            if best is None or m > best[2]:
                best = (int(host[0]), int(host[1]), m, hyp)
        if best is None:
            return None
        nid, fpos, m, hyp = best
        even_sf0 = sf0 + hyp * 10 * sf_len
        return {"n_id": nid, "frame_pos": fpos, "sf0_offset": even_sf0,
                "cfo_hz": cfo, "nsss_metric": m, "npss_metric": metric}


@dataclass(frozen=True)
class UeMibNbiot:
    """NPBCH decode loop over per-frame subframe-0 captures."""

    n_id: int

    @functools.cached_property
    def ofdm(self) -> NbOfdm:
        return NbOfdm()

    def decode(self, sf0_samples, device=None):
        """sf0_samples [nframes, 1920] -> (ok, MibNb, block_phase, frame).

        Tries each frame until one NPBCH repetition block decodes; the
        blind (block x port) hypothesis set resolves nf mod 64 // 8.
        """
        sf0_samples = as_tensor(sf0_samples, device)
        npbch = Npbch(self.n_id, nof_ports=2)
        for i in range(sf0_samples.shape[0]):
            grid = self.ofdm.rx_sf(sf0_samples[i])
            ce, _ = nb_chest(grid, self.n_id, sf_idx=0)
            ok, mib, block = npbch.decode(grid, ce)
            if ok:
                return True, mib, block, i
        return False, None, None, None


@dataclass(frozen=True)
class UeDlNbiot:
    """Per-subframe NB-IoT DL front end (ue_dl_nbiot.c analog)."""

    n_id: int

    @functools.cached_property
    def ofdm(self) -> NbOfdm:
        return NbOfdm()

    def fft_estimate(self, samples, sf_idx: int, device=None):
        """samples [..., 1920] -> (grid [..., 14, 12], ce, noise)."""
        grid = self.ofdm.rx_sf(samples, device)
        ce, noise = nb_chest(grid, self.n_id, sf_idx)
        return grid, ce, noise

    def search_npdcch(self, grid, ce, rnti: int, sf_idx: int):
        """Blind NPDCCH search -> ((ncce, fmt), DciN0/N1) or None."""
        return Npdcch(self.n_id, sf_idx).search(grid, ce, rnti)

    def decode_npdsch(self, grids, ces, sf_nf: tuple, grant: NbDlGrant,
                      rnti: int):
        """Multi-subframe NPDSCH decode -> (bits, crc_ok)."""
        return Npdsch(self.n_id, grant, rnti).decode(grids, ces, sf_nf)
