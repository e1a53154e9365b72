"""The JAX package's blind receiver on the streams of `chip_smoke.py` phase 12.

`python tests/rehearse_blind_receive.py` (on the CPU, about 4 minutes and
1.5 GB): builds the phase's 20 MHz capture with the port's example eNB on
the CPU (`chip_smoke.blind_capture`, the same frames and seeds), stream A
as it is and stream B with the phase's impairments
(`chip_smoke.blind_impaired`), and runs `examples/pdsch_ue.receive` of the
JAX package on each.  It prints, per stream, the cell, the MIB, the
subframes emitted, the DCI found and the TBs that pass their CRC (and
whether they equal the bits sent): the counts phase 12's TB gates are set
against (`BLIND_JAX_TB_OK_A`, `BLIND_TB_OK`).

Not a test (pytest does not collect it): a full-width run of the JAX
package takes minutes on the CPU.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from examples.pdsch_ue import receive  # noqa: E402
from srslte_tpu_torch.phy.common.params import Cell  # noqa: E402


def main():
    torch.set_num_threads(2)
    cell = Cell(n_prb=cs.BLIND_PRB, id=cs.BLIND_CELL_ID, nof_ports=1)
    a, bits, _, _ = cs.blind_capture(cell, device="cpu")
    b = cs.blind_impaired(a, cell.ofdm.symbol_sz)
    for name, x in (("A", a), ("B", b)):
        t0 = time.perf_counter()
        out = cs.blind_receive(x, receive)
        res = out["results"]
        ok = [r for r in res if r["crc_ok"]]
        equal = all(np.array_equal(r["bits"], bits[r["sf_idx"]]) for r in ok)
        print(f"stream {name}: cell {out['cell'].id if out['cell'] else None}, {out['mib']}; "
              f"{len(res)} subframes, DCI {sum(r['dci'] is not None for r in res)}, CFI 2 in "
              f"{sum(r['cfi'] == 2 for r in res)}, TB ok {len(ok)} (CRC per subframe "
              f"{''.join(str(int(r['crc_ok'])) for r in res)}), passing TBs equal to the bits "
              f"sent: {equal}; {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
