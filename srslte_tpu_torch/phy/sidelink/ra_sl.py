"""Sidelink resource allocation: PSCCH pools, TRPs, RIV (36.213 §14.1/14.2).

Reference behavior: lib/src/phy/phch/ra_sl.c — available pool PRBs,
PSCCH resource pair derivation (two PRBs x two subframes from n_pscch per
36.213 §14.2.1.1/.2), sidelink type-0 RIV (= UL type 2), PSSCH
time-resource-pattern gating, and the TRP index sets per k_TRP
(srsran_sci_generate_trp_idx).

The 36.213 tables 14.1.1.1.1-1/2/3 enumerating TRP
bitmaps are pure combinatorics — bitmap(I_TRP)[j] = bit j of I_TRP, and
the per-k index lists are the popcount classes in ascending order — so
they are generated rather than stored.  Random TRP choice is left to the
caller (deterministic choice lists instead of the reference's
gettimeofday-seeded RNG, ra_sl.c:131-137), keeping this module pure.
"""

from __future__ import annotations

import functools

from ..phch.ra import riv_type2, riv_type2_decode


def available_pool_prb(prb_num: int, prb_start: int, prb_end: int) -> int:
    """Usable PSCCH-pool PRB count M (ra_sl.c:29-37)."""
    if prb_num * 2 <= prb_end - prb_start + 1:
        return prb_num * 2
    return prb_num * 2 - 1


def pscch_resources(prb_num: int, prb_start: int, prb_end: int,
                    sf_bitmap, n_pscch: int):
    """PSCCH resource n_pscch -> ((prb_a, prb_b), (sf_a, sf_b)).

    Two frequency-diverse PRBs and two time-diverse pool subframes per
    36.213 §14.2.1.1/.2 (ra_sl.c:38-93).
    """
    m = available_pool_prb(prb_num, prb_start, prb_end)
    pool_sfs = [i for i, v in enumerate(sf_bitmap) if v]
    l = len(pool_sfs)
    if l < 2:
        raise ValueError("PSCCH subframe pool needs >= 2 subframes")
    n_pscch %= l * m // 2
    a1, b1 = n_pscch // l, n_pscch % l
    a2 = a1 + m // 2
    b2 = (n_pscch + 1 + (a1 % (l - 1))) % l
    return ((a1 + prb_start, a2 + (prb_end + 1 - m)),
            (pool_sfs[b1], pool_sfs[b2]))


def ra_sl_type0_to_riv(nof_prb: int, prb_start: int, l_crb: int) -> int:
    """Sidelink type 0 == UL type 2 RIV (36.213 §8.1.1, ra_sl.c:96)."""
    return riv_type2(nof_prb, prb_start, l_crb)


def ra_sl_type0_from_riv(riv: int, nof_prb: int) -> tuple[int, int]:
    """-> (prb_start, l_crb)."""
    return riv_type2_decode(nof_prb, riv)


def n_trp(duplex_mode: str, tdd_config: int = 0) -> int:
    """TRP bitmap length (ra_sl.c:107-129 case structure)."""
    if duplex_mode == "fdd":
        return 8
    if tdd_config in (3, 6):
        return 6
    if tdd_config == 0:
        return 7
    if tdd_config in (1, 2, 4, 5):
        return 8
    raise ValueError(f"invalid tdd_config {tdd_config}")


def trp_bitmap(trp_idx: int, n: int) -> tuple[int, ...]:
    """36.213 tables 14.1.1.1.1-1/2/3 row: b_j = bit j of I_TRP."""
    return tuple((trp_idx >> j) & 1 for j in range(n))


@functools.lru_cache(maxsize=None)
def trp_indices_for_k(n: int, k_trp: int) -> tuple[int, ...]:
    """Valid I_TRP values whose bitmap has k_TRP ones (the reference's
    srsran_sl_N_TRP_{6,7,8}_k_* lists, generated)."""
    return tuple(i for i in range(1 << n) if bin(i).count("1") == k_trp)


def pssch_allowed_sf(pssch_sf_idx: int, trp_idx: int, duplex_mode: str,
                     tdd_config: int = 0) -> bool:
    """Does the TRP transmit in this pool subframe? (ra_sl.c:107-129)."""
    n = n_trp(duplex_mode, tdd_config)
    return bool(trp_bitmap(trp_idx, n)[pssch_sf_idx % n])


def sci_trp_choices(duplex_mode: str, k_trp: int,
                    tdd_config: int = 0) -> tuple[int, ...]:
    """Deterministic candidate list for SCI time-resource patterns; the
    caller picks one (the reference picks uniformly at random)."""
    n = n_trp(duplex_mode, tdd_config)
    valid_k = {8: (1, 2, 4, 8), 7: tuple(range(1, 8)), 6: tuple(range(1, 7))}
    if k_trp not in valid_k[n]:
        raise ValueError(f"k_TRP={k_trp} invalid for N_TRP={n}")
    return trp_indices_for_k(n, k_trp)
