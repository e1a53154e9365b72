"""Standalone NB-IoT DL transmitter — lib/examples/npdsch_enodeb.c analog.

Generates a standalone NB-IoT carrier at 1.92 Msps: NPSS/NSSS/NRS/NPBCH
every frame, plus a DCI N1 on NPDCCH and the granted NPDSCH payload in one
frame, and writes the complex64 samples to a file decodable by
`srslte_tpu_torch.examples.npdsch_ue`.  The frames are composed and
modulated on the device; the file is written from the host.

Usage: python -m srslte_tpu_torch.examples.npdsch_enodeb out.bin --nid 257 \
           --rnti 0x2345 --frames 8 --i-mcs 5 --i-sf 1 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve
from ..phy.nbiot.npbch import MibNb
from ..phy.nbiot.npdcch import DciN1, Npdcch, pack_dci_n1
from ..phy.nbiot.npdsch import NbDlGrant, Npdsch
from ..phy.nbiot.ue import NbEnbDl


def generate(nid: int, rnti: int, frames: int, i_mcs: int, i_sf: int,
             dci_frame: int = 1, seed: int = 0, device=None) -> np.ndarray:
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    enb = NbEnbDl(nid)
    mib = MibNb(sfn_msb=0, sched_info_sib1=3, sys_info_tag=1, op_mode=2)
    dci = DciN1(i_sf=i_sf, i_mcs=i_mcs, ndi=1)
    grant = NbDlGrant(i_tbs=i_mcs, i_sf=i_sf)
    bits = rng.integers(0, 2, grant.tbs).astype(np.float32)
    data_sfs = tuple(3 + i for i in range(grant.nof_sf))
    sf_nf = tuple((s, dci_frame) for s in data_sfs)
    tx_grids = Npdsch(nid, grant, rnti).encode(
        torch.as_tensor(bits, device=dev),
        [torch.zeros((2, 14, 12), dtype=torch.complex64, device=dev) for _ in data_sfs], sf_nf)

    out = []
    for nf in range(frames):
        data = {}
        if nf == dci_frame:
            data[1] = lambda g: Npdcch(nid, sf_idx=1).encode(
                g, pack_dci_n1(dci), rnti)
            for i, s in enumerate(data_sfs):
                data[s] = lambda g, i=i: g + tx_grids[i]
        out.append(enb.frame_signal(mib, nf, data, device=dev))
    sig = torch.cat(out).cpu().numpy().astype(np.complex64)
    print(f"generated {frames} frames ({len(sig)} samples), TBS {grant.tbs}, "
          f"payload bits sum {int(bits.sum())}")
    return sig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--nid", type=lambda s: int(s, 0), default=257)
    ap.add_argument("--rnti", type=lambda s: int(s, 0), default=0x2345)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--i-mcs", type=int, default=5)
    ap.add_argument("--i-sf", type=int, default=1)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)
    generate(a.nid, a.rnti, a.frames, a.i_mcs, a.i_sf, device=a.device).tofile(a.out)


if __name__ == "__main__":
    main()
