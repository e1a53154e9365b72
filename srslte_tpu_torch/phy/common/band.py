"""EARFCN <-> carrier frequency helpers (36.101 §5.7.3, phy_common.c).

Reference behavior: lib/src/phy/common/phy_common.c lte_bands table +
srsran_band_fd:674 / get_fu:639 / srsran_band_get_band:661 /
srsran_band_is_tdd:648.  Host code only.  Band data ships beside this file
as lte_bands.npy, columns: band, F_DL_low MHz, N_Offs_DL, N_Offs_UL, duplex
spacing MHz.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_PATH = os.path.join(os.path.dirname(__file__), "lte_bands.npy")


@functools.lru_cache(maxsize=1)
def _bands() -> np.ndarray:
    return np.load(_PATH)


def band_from_dl_earfcn(dl_earfcn: int) -> int:
    """Band number owning a DL EARFCN (srsran_band_get_band)."""
    t = _bands()
    i = len(t) - 1
    if dl_earfcn > t[i][2]:
        raise ValueError(f"invalid DL EARFCN {dl_earfcn}")
    i -= 1
    while i > 0 and t[i][2] > dl_earfcn:
        i -= 1
    return int(t[i][0])


def _row(band: int) -> np.ndarray:
    t = _bands()
    hit = t[t[:, 0] == band]
    if not len(hit):
        raise ValueError(f"unknown LTE band {band}")
    return hit[0]


def dl_freq_hz(dl_earfcn: int) -> float:
    """F_DL = F_DL_low + 0.1 MHz * (N_DL - N_Offs_DL)."""
    r = _row(band_from_dl_earfcn(dl_earfcn))
    return (r[1] + 0.1 * (dl_earfcn - r[2])) * 1e6


def ul_freq_hz(ul_earfcn: int) -> float:
    """F_UL from the UL EARFCN (duplex-spaced below F_DL_low)."""
    t = _bands()
    fdd = t[t[:, 3] > 0]
    i = len(fdd) - 1
    while i > 0 and fdd[i][3] > ul_earfcn:
        i -= 1
    r = fdd[i]
    return (r[1] - r[4] + 0.1 * (ul_earfcn - r[3])) * 1e6


def ul_earfcn_from_dl(dl_earfcn: int) -> int:
    """Default UL EARFCN paired with a DL EARFCN (N_UL = N_DL + offset)."""
    r = _row(band_from_dl_earfcn(dl_earfcn))
    if r[3] == 0:
        return dl_earfcn  # TDD: same carrier
    return int(dl_earfcn - r[2] + r[3])


def band_is_tdd(band: int) -> bool:
    return _row(band)[3] == 0


# ---------------------------------------------------------------------------
# NR global frequency raster + FR1 bands (38.104 §5.4.2.1, band_helper.cc)
# ---------------------------------------------------------------------------
# (N_REF_min, N_REF_max, delta_F_kHz, F_REF_Offs_Hz, N_REF_Offs)
_NR_RASTER = (
    (0, 599999, 5, 0.0, 0),
    (600000, 2016666, 15, 3_000_000_000.0, 600000),
    (2016667, 3279165, 60, 24_250_080_000.0, 2016667),
)

# FR1 operating bands (38.101-1 table 5.4.2.3-1 subset covering the
# reference's nr_band_table NSA deployments): band, dl_nref_first,
# dl_nref_last, dl_nref_step
_NR_BANDS = (
    (1, 422000, 434000, 20), (2, 386000, 398000, 20),
    (3, 361000, 376000, 20), (5, 173800, 178800, 20),
    (7, 524000, 538000, 20), (8, 185000, 192000, 20),
    (20, 158200, 164200, 20), (25, 386000, 399000, 20),
    (28, 151600, 160600, 20), (38, 514000, 524000, 20),
    (40, 460000, 480000, 20), (41, 499200, 537999, 3),
    (66, 422000, 440000, 20), (71, 123400, 130400, 20),
    (77, 620000, 680000, 1), (78, 620000, 653333, 1),
    (79, 693334, 733333, 1),
)


def nr_arfcn_to_freq(nr_arfcn: int) -> float:
    """NR-ARFCN -> Hz on the global raster (band_helper.cc:33-37)."""
    for lo, hi, df, f0, n0 in _NR_RASTER:
        if lo <= nr_arfcn <= hi:
            return f0 + df * 1e3 * (nr_arfcn - n0)
    raise ValueError(f"NR-ARFCN {nr_arfcn} outside the global raster")


def freq_to_nr_arfcn(freq_hz: float) -> int:
    """Hz -> nearest NR-ARFCN (band_helper.cc freq_to_nr_arfcn)."""
    for lo, hi, df, f0, n0 in _NR_RASTER:
        n = round((freq_hz - f0) / (df * 1e3)) + n0
        if lo <= n <= hi:
            return int(n)
    raise ValueError(f"{freq_hz} Hz outside the NR global raster")


def get_bands_nr(nr_arfcn: int) -> list:
    """All FR1 bands whose DL raster contains the ARFCN
    (band_helper.cc:40-50 incl. the channel-raster step check)."""
    out = []
    for band, first, last, step in _NR_BANDS:
        if first <= nr_arfcn <= last and (nr_arfcn - first) % step == 0:
            out.append(band)
    return out
