"""Standalone cell scanner — lib/examples/cell_search.c analog.

Scans an IQ capture (complex64 file) for LTE cells: batched PSS/SSS search
over every half-frame window, majority vote on the PCI, CFO estimate, then
MIB decode for the system bandwidth.  The reference scans an EARFCN range
over live RF; here the input is a capture or a virtual-RF stream, copied to
the device once.

Usage: python -m srslte_tpu_torch.examples.cell_search in.bin --prb 6 \
           [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .._device import as_tensor
from ..phy.common.params import Cell, OfdmParams
from ..phy.ue.ue_cell_search import cell_search
from ..phy.ue.ue_mib import UeMib
from ..phy.ue.ue_sync import UeSync


def scan(samples, n_prb: int, device=None):
    """samples [L] (numpy or tensor) -> None, or {"cell_id", "cfo_sc",
    "votes"} and, where the MIB of one of the first 10 tracked subframes
    decodes, "mib" and "nof_ports"."""
    p = OfdmParams(n_prb)
    x = as_tensor(samples, device).to(torch.complex64)
    cs = cell_search(x, p)
    cell_id = int(cs.cell_id)
    if cell_id < 0:
        return None
    out = {"cell_id": cell_id, "cfo_sc": float(cs.cfo), "votes": int(cs.votes)}
    cell = Cell(n_prb=n_prb, id=cell_id, nof_ports=1)
    sync = UeSync(cell)
    st = sync.find(x)
    if st is not None:
        try:
            sfs, _ = sync.track_block(x, st, n_sf=10)
        except ValueError:
            return out
        mib_dec = UeMib(cell_id, n_prb)
        for i in range(sfs.shape[0]):
            ok, mib, phase, ports = mib_dec.decode(sfs[i])
            if ok:
                out["mib"] = mib
                out["nof_ports"] = ports
                break
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("--prb", type=int, default=6,
                    help="scan numerology (sets the sample rate)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)
    got = scan(np.fromfile(a.infile, np.complex64), a.prb, device=a.device)
    if got is None:
        print("no cell found")
        sys.exit(1)
    print(f"found cell: PCI {got['cell_id']}, CFO {got['cfo_sc']:.3f} "
          f"subcarriers, votes {got['votes']}")
    if got.get("mib") is not None:
        print(f"MIB: {got['mib']}")
    sys.exit(0)


if __name__ == "__main__":
    main()
