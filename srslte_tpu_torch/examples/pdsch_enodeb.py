"""Standalone DL transmitter: lib/examples/pdsch_enodeb.c equivalent.

Generates LTE radio frames (CRS + PSS/SSS + PBCH + PCFICH + PDCCH DCI-1A +
PDSCH with a seeded random payload) into an IQ capture file, which
`srslte_tpu_torch.examples.pdsch_ue` receives and decodes without prior
coordination beyond the RNTI.

The 10 subframes of a frame are built as one batch: each step (CRS,
PSS/SSS, PBCH in subframe 0, PCFICH, PDCCH, PDSCH, the OFDM modulator) is
one batched call or scatter on the device.  What differs from subframe to
subframe (CRS values, scrambling sequences, the PDCCH location) comes from
host tables built per subframe; the PDSCH is encoded once per RE-map class
(subframe 0 with PBCH and PSS/SSS, subframe 5 with PSS/SSS, the others),
since the three classes carry different numbers of coded bits.

Usage: python -m srslte_tpu_torch.examples.pdsch_enodeb out.bin --prb 100 \
           --cell-id 301 --mcs 27 --rnti 0x1234 --frames 4 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve
from ..phy.chest.refsignal_dl import crs_index_tensors, crs_pilots
from ..phy.common.params import Cell
from ..phy.common.scrambling import pdcch_cinit, pdsch_cinit
from ..phy.common.sequence import gold_sequence
from ..phy.common.zc import pss_sequence
from ..phy.enb.enb_dl import EnbDl
from ..phy.fec.convolutional import conv_encode, rm_conv_tx
from ..phy.fec.crc import LTE_CRC16, crc_bits
from ..phy.io import FileSink
from ..phy.modem.modem import Modulation, modulate
from ..phy.phch.dci import Dci1A, pack_format1a
from ..phy.phch.dlsch import dlsch_encode
from ..phy.phch.pbch import Mib
from ..phy.phch.pcfich import Pcfich, cfi_codeword_bits
from ..phy.phch.pdcch import Pdcch, rnti_mask, ue_locations
from ..phy.phch.pdsch import Pdsch, sf_flags
from ..phy.sync.sss import sss_sequence

CFI = 2
SUBFRAMES = tuple(range(10))


def _flat(grids):
    """[10, nports, nsym, nre] -> a view [10, nports, nsym * nre]."""
    return grids.view(grids.shape[:-2] + (-1,))


def put_base(cell: Cell, grids):
    """CRS of every port in all 10 subframes and PSS/SSS (36.211 §6.11, FDD
    and TDD placement as `EnbDl.put_pss_sss`), in place."""
    dev = grids.device
    for p in range(cell.nof_ports):
        syms, ks = crs_index_tensors(cell, p, dev)
        pilots = np.stack([crs_pilots(cell, sf, p) for sf in SUBFRAMES])  # [10, S, 2nprb]
        grids[:, p, syms, ks] = torch.as_tensor(pilots, device=dev)
    o = cell.ofdm
    pss = pss_sequence(cell.n_id_2)
    sss = {sf: sss_sequence(cell.n_id_1, cell.n_id_2, sf5=(sf == 5)).astype(np.complex64)
           for sf in (0, 5)}
    if cell.frame_type == "tdd":  # SSS closes subframes 0/5, PSS in symbol 2 of 1/6
        rows = [(0, o.nsymb_sf - 1, sss[0]), (5, o.nsymb_sf - 1, sss[5]), (1, 2, pss), (6, 2, pss)]
    else:  # SSS and PSS close slot 0 of subframes 0/5
        rows = [(sf, o.nsymb_slot - 2, sss[sf]) for sf in (0, 5)]
        rows += [(sf, o.nsymb_slot - 1, pss) for sf in (0, 5)]
    sf_t = torch.tensor([r[0] for r in rows], device=dev)[:, None]
    sym_t = torch.tensor([r[1] for r in rows], device=dev)[:, None]
    k_t = torch.arange(o.nof_re // 2 - 31, o.nof_re // 2 + 31, device=dev)
    grids[sf_t, 0, sym_t, k_t] = torch.as_tensor(np.stack([r[2] for r in rows]), device=dev)


def put_pcfich(cell: Cell, grids, cfi: int):
    """The CFI codeword of every subframe (scrambled per subframe), in place."""
    dev = grids.device
    cw = np.stack([cfi_codeword_bits(cell.id, sf, cfi) for sf in SUBFRAMES])  # [10, 32]
    idx = torch.as_tensor(Pcfich(cell, 0).re_idx.astype(np.int64), device=dev)
    _flat(grids)[:, 0, idx] = modulate(torch.as_tensor(cw, device=dev), Modulation.QPSK)


def put_pdcch(cell: Cell, grids, cfi: int, payload: np.ndarray, rnti: int):
    """One DCI per subframe at the first location of the UE's search space
    (36.213 §9.1.1; always aggregation level 1), in place.  The coded bits
    are the same in every subframe; the scrambling and the location differ."""
    dev = grids.device
    pd = Pdcch(cell, cfi, 0)
    locs = [ue_locations(pd.n_cce, rnti, sf)[0] for sf in SUBFRAMES]
    L = locs[0].L
    if any(loc.L != L for loc in locs):
        raise ValueError("the search spaces' first locations differ in aggregation level")
    e = 72 * L
    msg = np.concatenate([payload, crc_bits(payload, *LTE_CRC16) ^ rnti_mask(rnti)])
    coded = rm_conv_tx(conv_encode(torch.as_tensor(msg, device=dev), len(msg)), e)  # [e]
    scr = np.stack([gold_sequence(pdcch_cinit(sf, cell.id), pd.n_cce * 72)
                    [loc.cce * 72 : loc.cce * 72 + e] for sf, loc in zip(SUBFRAMES, locs)])
    sym = modulate(coded ^ torch.as_tensor(scr, device=dev), Modulation.QPSK)  # [10, 36L]
    idx = np.stack([pd.re_idx[loc.cce * 36 : (loc.cce + L) * 36] for loc in locs])
    rows = torch.arange(len(SUBFRAMES), device=dev)[:, None]
    _flat(grids)[rows, 0, torch.as_tensor(idx.astype(np.int64), device=dev)] = sym


def put_pdsch(cell: Cell, grids, grant, cfi: int, rnti: int, bits):
    """The PDSCH of every subframe, in place: DL-SCH encoding once per
    RE-map class, scrambling per subframe, one scatter per class."""
    dev = grids.device
    classes = {}
    for sf in SUBFRAMES:
        classes.setdefault(sf_flags(sf), []).append(sf)
    for sfs in classes.values():
        pdsch = Pdsch(cell, grant, sfs[0], cfi=cfi, rnti=rnti)
        rows = torch.tensor(sfs, device=dev)
        coded = dlsch_encode(bits[rows], pdsch.cfg)  # [n, G]
        scr = np.stack([gold_sequence(pdsch_cinit(rnti, 0, sf, cell.id), pdsch.cfg.G)
                        for sf in sfs])
        sym = modulate(coded ^ torch.as_tensor(scr, device=dev), grant.modulation)
        idx = torch.as_tensor(pdsch.re_idx.astype(np.int64), device=dev)
        _flat(grids)[rows[:, None], 0, idx] = sym


def make_frame(cell: Cell, rnti: int, mcs: int, sfn: int, seed: int, device=None):
    """One 10-ms frame of samples: (samples [10, sf_len] complex64 on the
    device, bits [10, tbs] uint8 numpy).  The bits come from
    `np.random.default_rng(seed)`, as in the JAX package's example."""
    dev = resolve(device)
    enb = EnbDl(cell)
    mib = Mib(cell.n_prb, cell.phich_length, cell.phich_resources, sfn)
    dci = Dci1A(rb_start=0, l_crb=cell.n_prb, mcs=mcs)
    grant = dci.grant(cell.n_prb)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (10, grant.tbs)).astype(np.uint8)

    grids = enb.empty_grids((len(SUBFRAMES),), dev)
    put_base(cell, grids)
    grids[0] = enb.put_pbch(grids[0], mib)
    put_pcfich(cell, grids, CFI)
    put_pdcch(cell, grids, CFI, pack_format1a(dci, cell.n_prb), rnti)
    put_pdsch(cell, grids, grant, CFI, rnti, torch.as_tensor(bits, device=dev))
    return enb.gen_signal(grids)[:, 0], bits  # port 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("--prb", type=int, default=6)
    ap.add_argument("--cell-id", type=int, default=123)
    ap.add_argument("--mcs", type=int, default=5)
    ap.add_argument("--rnti", type=lambda x: int(x, 0), default=0x1234)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cell = Cell(n_prb=args.prb, id=args.cell_id, nof_ports=1)
    sink = FileSink(args.output)
    for f in range(args.frames):
        s, _ = make_frame(cell, args.rnti, args.mcs, sfn=f, seed=args.seed, device=args.device)
        sink.write(s.reshape(-1).cpu().numpy())
    sink.close()
    print(f"wrote {args.frames} frames ({args.prb} PRB, cell {args.cell_id}) "
          f"to {args.output}")


if __name__ == "__main__":
    main()
