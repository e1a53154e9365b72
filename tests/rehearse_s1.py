"""The JAX package's full stack over the S1 wire on the scenarios of
`chip_smoke.py` phase 19: where the phase's state-transition TTIs, S1AP
procedure order and delivered counts come from.

`python tests/rehearse_s1.py` (on the CPU; about 13 and 10 minutes for the
two runs at 100 PRB, about 3 GB) runs `chip_smoke.s1_scenario` on the JAX
package's `EnbApp(s1=...)`, `UeApp` and wire `EpcApp` at
`chip_smoke.STACK_PRB`, twice in one process, and prints for each run the
first TTI at which each state was reached, the TTIs run, the gates, the
counts and the S1AP procedures in the order they crossed the association;
last one JSON line `{"runs": [...], "agree": bool}`, whose states and
procedures `chip_smoke.S1_JAX` holds.  The two runs show whether the
timeline over the loopback sockets is deterministic: phase 19 holds the
port equal to a value only where they agree (they agree on every one).

Not a test (pytest does not collect it): full-width runs of the JAX package
take minutes on the CPU.
"""

import json
import os
import sys
import time
import types

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from srslte_tpu.enb import EnbApp  # noqa: E402
from srslte_tpu.epc import Hss  # noqa: E402
from srslte_tpu.epc.wire import EpcApp  # noqa: E402
from srslte_tpu.nas.keys import kdf_kenb  # noqa: E402
from srslte_tpu.net.s1_transport import sctp_supported  # noqa: E402
from srslte_tpu.phy.common.params import Cell  # noqa: E402
from srslte_tpu.s1ap import s1ap_unpack  # noqa: E402
from srslte_tpu.security.milenage import compute_opc  # noqa: E402
from srslte_tpu.ue import UeApp  # noqa: E402
from srslte_tpu.ue_stack import SoftUsim, UeNas  # noqa: E402

JAX_S1 = types.SimpleNamespace(
    EnbApp=EnbApp, UeApp=UeApp, UeNas=UeNas, SoftUsim=SoftUsim, Hss=Hss, EpcApp=EpcApp,
    Cell=Cell, compute_opc=compute_opc, kdf_kenb=kdf_kenb, sctp_supported=sctp_supported,
    s1ap_unpack=s1ap_unpack)


def main():
    runs = []
    for run in range(2):
        t0 = time.perf_counter()
        first, ttis, gates, counts, log = cs.s1_scenario(JAX_S1)
        procs = [f"{d}:{p}" for _, d, p in log]
        print(f"[run {run + 1}] {ttis} TTIs in {time.perf_counter() - t0:.1f} s on the CPU; first "
              f"TTI per state {first}; gates {gates}; counts {counts}; S1AP {log}", flush=True)
        runs.append({"first": first, "procedures": procs, "gates": gates, "counts": counts})
    agree = all(r["first"] == runs[0]["first"] and r["procedures"] == runs[0]["procedures"]
                for r in runs)
    print(json.dumps({"runs": runs, "agree": agree}))


if __name__ == "__main__":
    main()
