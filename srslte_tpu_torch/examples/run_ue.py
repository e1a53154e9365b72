"""Standalone UE process (srsue analog — test/run_lte.sh topology).

Lockstep virtual RF over the native UDP sample pipe: the UE announces
itself with one zero "hello" subframe, then for every DL subframe read it
answers with exactly one UL subframe (zeros when idle), so both ends stay
sample-aligned on the byte-stream ring.  After attach, sends one UL user
packet and waits for the EPC's SGi echo to come back down the DRB; prints
progress lines ("UE ready", "ATTACHED tti=...", "DL_DATA ...").  The PHY
runs on `--device` (default: the CUDA device; none raises).

Usage: python -m srslte_tpu_torch.examples.run_ue [dl_port=2101]
           [ul_port=2100] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve
from ..phy.common.params import Cell
from ..runtime import SamplePipeRx, SamplePipeTx
from ..security.milenage import compute_opc
from ..ue import UeApp
from ..ue_stack import SoftUsim, UeNas
from ..utils import crash

IMSI = "001010123456789"
K = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dl_port", type=int, nargs="?", default=2101)
    ap.add_argument("ul_port", type=int, nargs="?", default=2100)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)
    device = resolve(a.device)  # raises before any socket opens when there is no card
    torch.set_num_threads(1)  # the three processes share the host's cores
    crash.install()
    rx = SamplePipeRx(a.dl_port)  # bind before slow init so no DL is dropped
    tx = SamplePipeTx("127.0.0.1", a.ul_port)
    cell = Cell(n_prb=15, id=1, nof_ports=1)
    ue = UeApp(cell, UeNas(SoftUsim(IMSI, K, compute_opc(K, OP))), device=device)
    sf_len = cell.ofdm.sf_len
    tx.send(np.zeros(sf_len, np.complex64))  # hello: starts the eNB's loop
    print("UE ready", flush=True)
    tti = 0
    attached_at = -1
    sent = False
    while tti < 1500:
        # generous first-read budget: the eNB builds its tables before
        # subframe 0 arrives; later reads only wait on lockstep
        dl = rx.read(sf_len, timeout_ms=300_000 if tti == 0 else 60_000)
        if len(dl) < sf_len:
            print("DL_TIMEOUT", flush=True)
            break  # eNB gone
        ue.rx_subframe(dl, tti)
        ul = ue.tx_subframe(tti)
        tx.send(np.zeros(sf_len, np.complex64) if ul is None
                else ul.cpu().numpy().astype(np.complex64))
        if attached_at < 0 and ue.nas.state == "attached":
            attached_at = tti
            print(f"ATTACHED tti={tti} ip={ue.nas.ip}", flush=True)
        if attached_at >= 0 and not sent and tti >= attached_at + 30:
            ue.send_data(b"ping-3proc")
            sent = True
        if ue.rx_data:
            print(f"DL_DATA {ue.rx_data[0].decode(errors='replace')}", flush=True)
            break
        tti += 1


if __name__ == "__main__":
    main()
