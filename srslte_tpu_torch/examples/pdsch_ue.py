"""Standalone LTE receiver: lib/examples/pdsch_ue.c equivalent.

Full blind receive chain from an IQ capture: cell search -> PSS/SSS sync ->
MIB decode -> PDCCH blind DCI search -> PDSCH decode, printing per-subframe
results.  Only the RNTI (and the file's sample rate via --prb) must be
known, as with the C library's example.

The capture goes to the device in one copy.  The stream is tracked in blocks
of 5 subframes (`UeSync.track_block`), and each subframe is decoded on its
own, as in the JAX package's example: the decision of each step (the CFI,
the DCI hits, the CRC) is read back on the host before the next.

Usage: python -m srslte_tpu_torch.examples.pdsch_ue in.bin --prb 100 \
           --rnti 0x1234 [--max-sf 40] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from .._device import as_tensor
from ..phy.common.params import Cell, OfdmParams
from ..phy.io import FileSource
from ..phy.phch.dci import format0_1a_size, unpack_format1a
from ..phy.phch.pcfich import Pcfich
from ..phy.phch.pdcch import Pdcch
from ..phy.phch.pdsch import Pdsch
from ..phy.ue.ue_cell_search import cell_search
from ..phy.ue.ue_dl import UeDl
from ..phy.ue.ue_mib import UeMib
from ..phy.ue.ue_sync import UeSync

TRACK_BLOCK = 5  # subframes per UeSync.track_block


def receive(samples, n_prb: int, rnti: int, max_sf: int = 20, device=None):
    """Blind receive of samples [L] (numpy or tensor); returns
    {"cell", "mib", "results"}: a dict per subframe with sf_idx, cfi, dci,
    crc_ok and (where a DCI was found) the decoded bits as numpy."""
    p = OfdmParams(n_prb)
    samples = as_tensor(samples, device).to(torch.complex64)
    cs = cell_search(samples, p)
    cell_id = int(cs.cell_id)
    if cell_id < 0:
        return {"cell": None, "results": []}
    print(f"cell search: PCI {cell_id}, CFO {float(cs.cfo):.3f} sc, "
          f"votes {int(cs.votes)}")

    cell = Cell(n_prb=n_prb, id=cell_id, nof_ports=1)
    sync = UeSync(cell)
    st = sync.find(samples)
    assert st is not None and st.cell_id == cell_id

    ue = UeDl(cell)
    mib = None
    results = []
    dci_size = format0_1a_size(n_prb)
    while len(results) < max_sf:
        try:
            sfs, st_next = sync.track_block(samples, st, n_sf=TRACK_BLOCK)
        except ValueError:
            break  # stream exhausted
        for i in range(TRACK_BLOCK):
            sf_idx = (st.sf_idx + i) % 10
            sf = sfs[i]
            if sf_idx == 0 and mib is None:
                ok, mib_dec, phase, ports = UeMib(cell_id, n_prb).decode(sf)
                if ok:
                    mib = mib_dec
                    print(f"MIB: {mib} (frame phase {phase}, {ports} port)")
            grid, ce, info = ue.fft_estimate(sf, sf_idx)
            cfi = int(Pcfich(cell, sf_idx).decode(grid, ce)[0])
            pd = Pdcch(cell, cfi, sf_idx)
            hits = pd.search(grid, ce, rnti, dci_size)
            entry = {"sf_idx": sf_idx, "cfi": cfi, "dci": None, "crc_ok": False}
            for loc, bits in hits:
                dci = unpack_format1a(bits, n_prb)
                if dci is None:
                    continue
                entry["dci"] = dci
                pdsch = Pdsch(cell, dci.grant(n_prb, rnti), sf_idx, cfi=cfi,
                              rnti=rnti)
                out, ok = pdsch.decode(grid, ce, info["noise"])
                entry["crc_ok"] = bool(ok)
                entry["bits"] = out.cpu().numpy()
                break
            results.append(entry)
        st = st_next
    return {"cell": cell, "mib": mib, "results": results}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("--prb", type=int, default=6)
    ap.add_argument("--rnti", type=lambda x: int(x, 0), default=0x1234)
    ap.add_argument("--max-sf", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    src = FileSource(args.input)
    samples = src.read(10**9)
    src.close()
    out = receive(samples, args.prb, args.rnti, args.max_sf, device=args.device)
    n_ok = sum(r["crc_ok"] for r in out["results"])
    print(f"decoded {n_ok}/{len(out['results'])} PDSCH subframes OK")
    return out


if __name__ == "__main__":
    main()
