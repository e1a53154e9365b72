"""Standalone NB-IoT receiver — lib/examples/npdsch_ue.c analog.

Full blind NB-IoT receive chain from a 1.92 Msps IQ capture: NPSS/NSSS
cell search -> CFO correction -> MIB-NB decode -> NPDCCH blind DCI search
-> NPDSCH decode, on the device.  Only the RNTI must be known, as with the
reference example.

Usage: python -m srslte_tpu_torch.examples.npdsch_ue in.bin --rnti 0x2345 \
           [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .._device import as_tensor
from ..phy.nbiot.npbch import Npbch
from ..phy.nbiot.npdsch import NbDlGrant
from ..phy.nbiot.ue import UeCellSearchNbiot, UeDlNbiot, cfo_correct

SF_LEN = 1920


def receive(samples, rnti: int, max_frames: int = 16, device=None):
    x = as_tensor(samples, device).to(torch.complex64)
    cs = UeCellSearchNbiot().search(x)
    if cs is None:
        print("no cell found")
        return None
    nid = cs["n_id"]
    print(f"cell search: NB cell id {nid}, frame_pos {cs['frame_pos']}, "
          f"CFO {cs['cfo_hz']:.1f} Hz, metric {cs['nsss_metric']:.3f}")
    x = cfo_correct(x, cs["cfo_hz"])
    sf0 = cs["sf0_offset"] % (20 * SF_LEN)

    ue = UeDlNbiot(nid)
    mib = None
    results = []
    nf = 0
    while sf0 + (nf + 1) * 10 * SF_LEN <= x.shape[-1] and nf < max_frames:
        base = sf0 + nf * 10 * SF_LEN
        if mib is None:
            g, ce, _ = ue.fft_estimate(x[base : base + SF_LEN], 0)
            ok, mib_got, block = Npbch(nid, 2).decode(g, ce)
            if ok:
                mib = mib_got
                print(f"MIB-NB: {mib} (block phase {block})")
        for sf_idx in (1, 2):
            s = base + sf_idx * SF_LEN
            g, ce, _ = ue.fft_estimate(x[s : s + SF_LEN], sf_idx)
            hit = ue.search_npdcch(g, ce[:1], rnti, sf_idx)
            if hit is None:
                continue
            _, dci = hit
            print(f"frame {nf} sf {sf_idx}: DCI {dci}")
            if not hasattr(dci, "i_sf"):
                continue
            grant = NbDlGrant(i_tbs=dci.i_mcs, i_sf=dci.i_sf)
            sf_nf = tuple((3 + i, nf) for i in range(grant.nof_sf))
            grids, ces = [], []
            for dsf, _ in sf_nf:
                ss = base + dsf * SF_LEN
                gd, ced, _ = ue.fft_estimate(x[ss : ss + SF_LEN], dsf)
                grids.append(gd)
                ces.append(ced)
            bits, ok = ue.decode_npdsch(torch.stack(grids), torch.stack(ces),
                                        sf_nf, grant, rnti)
            host = torch.cat([ok.reshape(1).to(torch.uint8), bits]).cpu().numpy()
            ok = bool(host[0])
            print(f"  NPDSCH TBS {grant.tbs}: CRC {'OK' if ok else 'KO'}")
            results.append({"frame": nf, "tbs": grant.tbs, "crc_ok": ok,
                            "bits": host[1:]})
        nf += 1
    return {"cell": cs, "mib": mib, "results": results}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("--rnti", type=lambda s: int(s, 0), default=0x2345)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)
    out = receive(np.fromfile(a.infile, np.complex64), a.rnti, device=a.device)
    n_ok = sum(r["crc_ok"] for r in out["results"]) if out else 0
    print(f"{n_ok} NPDSCH transport block(s) decoded")
    sys.exit(0 if n_ok else 1)


if __name__ == "__main__":
    main()
