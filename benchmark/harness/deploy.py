"""One LTE downlink deployment, built from a configuration file's values.

The same recipe builds the objects of the program (the package
`srslte_tpu_torch`) and of the reference (`benchmark.reference.lte`, a
frozen plain copy with the same module layout and names): `build(config,
package, device)` imports the package's modules by name, so each side holds
only objects of its own package.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import torch

PROGRAM = "srslte_tpu_torch"
REFERENCE = "benchmark.reference.lte"


def _mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


def candidates(pdcch_mod, n_cce: int, rnti: int, sf_idx: int, search: str):
    """The blind search's candidate locations: the UE-specific space of the
    RNTI, then the common locations not already in it ("ue_and_common")."""
    locs = pdcch_mod.ue_locations(n_cce, rnti, sf_idx)
    if search == "ue_and_common":
        locs += [loc for loc in pdcch_mod.common_locations(n_cce) if loc not in locs]
    elif search != "ue":
        raise ValueError(f"unknown search {search!r}")
    return locs


def tm4_pmi(pinfo: int) -> int:
    """The 2-layer codebook index (36.211 Table 6.3.4.2.3-1, the port's
    `pmi`) of DCI 2's precoding information with both codewords on 2 ports
    (36.212 Table 5.3.3.1.5-4): 0 -> [1 1; 1 -1]/2 (index 1), 1 -> [1 1;
    j -j]/2 (index 2).  2, the latest PMI reported on PUSCH, needs a report
    and is not a deployment here."""
    if pinfo not in (0, 1):
        raise ValueError(f"precoding information {pinfo} is not a fixed TPMI of "
                         f"two codewords on 2 ports")
    return pinfo + 1


def build(config: dict, package: str, device) -> SimpleNamespace:
    """The deployment of `config` from `package`'s classes, on `device`.

    Fields: cell, cfi, sf_idx, rnti, nrx, enb, ue, pcfich, phich (None
    without PHICH), pd, groups (the candidates by aggregation level, in
    search order), n_cand, codewords, mask (the RNTI's CRC mask on the device),
    dci (the DCI sent), dci_bits (uint8 numpy), dci_sent (the same on the
    device), dci_len, tx_loc, unpack,
    pdsch_for(dci) (the PDSCH processor a DCI schedules), pdsch (the
    one the DCI sent schedules), h (the channel matrix [nrx, nports] or
    None)."""
    params = _mod(package, "phy.common.params")
    dci_mod = _mod(package, "phy.phch.dci")
    pdcch_mod = _mod(package, "phy.phch.pdcch")
    pdsch_mod = _mod(package, "phy.phch.pdsch")
    c = config["cell"]
    cell = params.Cell(n_prb=c["n_prb"], id=c["id"], nof_ports=c["nof_ports"],
                       cp=params.CP[c["cp"]], phich_length=c["phich_length"],
                       phich_resources=c["phich_ng"], frame_type=c["frame_type"])
    n_prb, ports = cell.n_prb, cell.nof_ports
    cfi, sf_idx, rnti = config["cfi"], config["sf_idx"], config["rnti"]
    d = config["dci"]
    if d["format"] == "1A":
        dci = dci_mod.Dci1A(rb_start=d["rb_start"], l_crb=d["l_crb"], mcs=d["mcs"])
        dci_bits = dci_mod.pack_format1a(dci, n_prb)
        unpack = dci_mod.unpack_format1a
        codewords = 1

        def pdsch_for(x):
            return pdsch_mod.Pdsch(cell, x.grant(n_prb), sf_idx, cfi=cfi, rnti=rnti)
    elif d["format"] == "2":
        n_rbg = -(-n_prb // _mod(package, "phy.phch.ra").rbg_size(n_prb))
        mask = (1 << n_rbg) - 1 if d["rbg_bitmask"] == "all" else int(d["rbg_bitmask"])
        dci = dci_mod.Dci2(rbg_bitmask=mask, mcs=tuple(d["mcs"]), pinfo=d["pinfo"])
        dci_bits = dci_mod.pack_format2(dci, n_prb, ports)
        codewords = 2

        def unpack(bits, n):
            return dci_mod.unpack_format2(bits, n, ports)

        def pdsch_for(x):
            g0, g1 = x.grants(n_prb)
            return pdsch_mod.PdschSm(cell, g0, sf_idx, cfi=cfi, rnti=rnti,
                                     pmi=tm4_pmi(x.pinfo), grant1=g1)
    else:
        raise ValueError(f"unsupported DCI format {d['format']!r}")
    pd = pdcch_mod.Pdcch(cell, cfi, sf_idx)
    locs = candidates(pdcch_mod, pd.n_cce, rnti, sf_idx, config["search"])
    if "location" in d:
        tx_loc = pdcch_mod.Location(*d["location"])
    else:  # the first UE-specific candidate of the level
        tx_loc = [loc for loc in pdcch_mod.ue_locations(pd.n_cce, rnti, sf_idx)
                  if loc.L == d["level"]][0]
    if tx_loc not in locs:
        raise ValueError(f"the DCI's location {tx_loc} is not a candidate of the search")
    groups: dict = {}
    for loc in locs:
        groups.setdefault(loc.L, []).append(loc)
    h = config.get("channel")
    dev = torch.device(device)
    dep = SimpleNamespace(
        cell=cell, cfi=cfi, sf_idx=sf_idx, rnti=rnti, nrx=config["nof_rx"],
        enb=_mod(package, "phy.enb.enb_dl").EnbDl(cell),
        ue=_mod(package, "phy.ue.ue_dl").UeDl(cell, chest_algorithm=config["chest"]),
        pcfich=_mod(package, "phy.phch.pcfich").Pcfich(cell, sf_idx),
        phich=(_mod(package, "phy.phch.phich").Phich(cell, sf_idx)
               if config.get("phich") else None),
        pd=pd, groups=tuple(tuple(g) for g in groups.values()), n_cand=len(locs),
        codewords=codewords,
        mask=torch.as_tensor(pdcch_mod.rnti_mask(rnti), device=dev),
        dci=dci, dci_bits=np.asarray(dci_bits, np.uint8),
        dci_sent=torch.as_tensor(np.asarray(dci_bits, np.uint8), device=dev),
        dci_len=len(dci_bits),
        tx_loc=tx_loc, unpack=unpack, pdsch_for=pdsch_for, pdsch=pdsch_for(dci),
        h=None if h is None else torch.as_tensor(
            np.array([[complex(*v) for v in row] for row in h], np.complex64), device=dev))
    _expect(dep, config.get("expect", {}))
    return dep


def _expect(dep, want: dict):
    """Raise unless the deployment has the sizes its configuration states."""
    cfg = dep.pdsch.cfg
    have = {"tbs": cfg.tbs, "code_blocks": cfg.seg.C, "K": cfg.seg.K1, "candidates": dep.n_cand,
            "dci_bits": dep.dci_len,
            "phich_groups": dep.phich.ngroups if dep.phich is not None else None}
    wrong = {k: (v, have[k]) for k, v in want.items() if have[k] != v}
    if wrong:
        raise ValueError(f"the deployment's sizes differ from its configuration's "
                         f"(stated, built): {wrong}")
