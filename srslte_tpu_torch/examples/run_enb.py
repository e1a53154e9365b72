"""Standalone eNB process (srsenb analog — test/run_lte.sh topology).

Virtual RF over the native UDP sample pipe, lockstepped with the UE
process: we wait for the UE's one-subframe "hello", then per TTI transmit
the DL subframe and block for exactly one UL subframe, keeping the
byte-stream ring sample-aligned.  S1 toward the EPC process over the S1AP
association; user plane over GTP-U.  The PHY runs on `--device` (default:
the CUDA device; none raises); the samples cross the pipe from the host.

Usage: python -m srslte_tpu_torch.examples.run_enb <s1_port> [dl_port=2101]
           [ul_port=2100] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve
from ..enb import EnbApp
from ..phy.common.params import Cell
from ..runtime import SamplePipeRx, SamplePipeTx
from ..utils import crash


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("s1_port", type=int)
    ap.add_argument("dl_port", type=int, nargs="?", default=2101)
    ap.add_argument("ul_port", type=int, nargs="?", default=2100)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)
    device = resolve(a.device)  # raises before any socket opens when there is no card
    torch.set_num_threads(1)  # the three processes share the host's cores
    crash.install()
    rx = SamplePipeRx(a.ul_port)  # bind first so the UE hello is never lost
    tx = SamplePipeTx("127.0.0.1", a.dl_port)
    cell = Cell(n_prb=15, id=1, nof_ports=1)
    enb = EnbApp(cell, s1={"port": a.s1_port, "force_tcp": True}, device=device)
    sf_len = cell.ofdm.sf_len
    print("ENB ready", flush=True)
    hello = rx.read(sf_len, timeout_ms=300_000)
    if len(hello) < sf_len:
        print("NO_UE", flush=True)
        return
    tti = 0
    while True:
        tx.send(enb.tx_subframe(tti).cpu().numpy().astype(np.complex64))
        # the UE builds its tables on the first subframes; after that the
        # lockstep answer arrives within a TTI of work
        ul = rx.read(sf_len, timeout_ms=300_000 if tti < 3 else 60_000)
        enb.rx_subframe(ul if len(ul) == sf_len else None, tti)  # UE gone: serve silence
        tti += 1


if __name__ == "__main__":
    main()
