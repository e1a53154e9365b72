"""Standalone EPC process (srsepc analog — test/run_lte.sh topology).

S1AP server (SCTP or TCP-framed), GTP-C S11, GTP-U S1-U.  SGi echoes every
uplink packet back downlink with an "echo:" prefix and logs it, so an
external prober can verify the full user-plane loop.  Host only: the EPC
holds no tensor.

Usage: python -m srslte_tpu_torch.examples.run_epc <s1_port_file>
Writes the chosen S1AP port into <s1_port_file> (ephemeral ports keep
parallel runs from colliding), then prints one line per event.
"""

from __future__ import annotations

import argparse
import time

from ..epc import Hss
from ..epc.wire import EpcApp
from ..utils import crash

IMSI = "001010123456789"
K = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("port_file")
    a = ap.parse_args(argv)
    crash.install()
    hss = Hss()
    hss.add_subscriber(IMSI, K, op=OP)
    epc = EpcApp(hss, force_tcp=True, sgi_tx=None)

    def sgi_rx(ue_ip, pkt):
        print(f"SGI {ue_ip} {pkt.decode(errors='replace')}", flush=True)
        epc.spgw.send_dl(ue_ip, b"echo:" + pkt)

    epc.spgw.table.sgi_tx = sgi_rx
    with open(a.port_file, "w") as f:
        f.write(str(epc.s1_port))
    print(f"EPC ready s1_port={epc.s1_port}", flush=True)
    while True:
        epc.step()
        time.sleep(0.002)


if __name__ == "__main__":
    main()
