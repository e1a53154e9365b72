"""The JAX package's full stack on the scenarios of `chip_smoke.py` phase 18:
where the phase's state-transition TTIs and delivered counts come from.

`python tests/rehearse_stack.py [A B C D]` (on the CPU; minutes per
scenario, most of it XLA compiling each new shape) runs
`chip_smoke.stack_scenario` on the JAX package's `EnbApp`, `UeApp`, core
and UE NAS at `chip_smoke.STACK_PRB` and prints, per scenario, the first TTI
at which each state was reached, the TTIs run, the gates and the counts, and
last one JSON line `{"A": {...}, ...}` of the first-reached TTIs, which
`chip_smoke.STACK_JAX` holds.

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

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from srslte_tpu.enb import EnbApp  # noqa: E402
from srslte_tpu.epc import Hss, Mme, Spgw  # noqa: E402
from srslte_tpu.phy.common.params import Cell  # noqa: E402
from srslte_tpu.phy.phch.pdsch import Pdsch  # noqa: E402
from srslte_tpu.security.milenage import compute_opc  # noqa: E402
from srslte_tpu.ue import UeApp  # noqa: E402
from srslte_tpu.ue_stack import SoftUsim, UeNas  # noqa: E402

JAX_STACK = types.SimpleNamespace(
    EnbApp=EnbApp, UeApp=UeApp, UeNas=UeNas, SoftUsim=SoftUsim, Hss=Hss, Mme=Mme, Spgw=Spgw,
    Cell=Cell, compute_opc=compute_opc, Pdsch=Pdsch, crc_fail=lambda ok: jnp.asarray(False))


def main():
    names = sys.argv[1:] or ["A", "B", "C", "D"]
    out = {}
    for name in names:
        t0 = time.perf_counter()
        first, ttis, gates, counts = cs.stack_scenario(name, JAX_STACK)
        print(f"[{name}] {ttis} TTIs in {time.perf_counter() - t0:.1f} s on the CPU; first TTI "
              f"per state {first}; gates {gates}; counts {counts}", flush=True)
        out[name] = first
    print(json.dumps(out))


if __name__ == "__main__":
    main()
