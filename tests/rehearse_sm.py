"""The JAX package's spatial-multiplexing decode on the stimulus of
`chip_smoke.py` phases 13 and 14: where `SM_SNR_DB` and `SM4_SNR_DB` come
from.

`python tests/rehearse_sm.py` (on the CPU; minutes per point): builds 16
subframes of the phase's stimulus with the port's eNB on the CPU
(`chip_smoke.SmChain`: 100 PRB, DCI 2 / 2A, both TBs at mcs 27 over all 100
PRB, the 2x2 channel `SM_H2` or the 4x4 of `SM4_H_SEED`), adds AWGN at each
whole dB from `--start` down (`UlChain.noisy`, noise from `--seed`), and runs
the JAX package's `UeDl.fft_estimate` and `PdschSm.decode2` (`PdschSm4` for
the 4x4) on it, with rx 0's noise as the phases do.  It prints the TBs that
pass their CRC per codeword at each point and stops below 95 %; the lowest
whole dB at or above 95 % is the phase's SNR.  `--cells` picks the
deployments: tm4, tm3, sm4 (pmi 0), sm4cdd; `--chest` the UE's channel
estimate ("average", "interpolate", "wiener": phase 15 runs the last two on
phase 13's TM4 stimulus at `SM_SNR_DB`).

Not a test (pytest does not collect it): a full-width run of the JAX
package takes minutes on the CPU.
"""

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from srslte_tpu.phy.common.params import Cell  # noqa: E402
from srslte_tpu.phy.phch import dci as D  # noqa: E402
from srslte_tpu.phy.phch.pdsch import PdschSm, PdschSm4  # noqa: E402
from srslte_tpu.phy.ue.ue_dl import UeDl  # noqa: E402

N_SF = 16
DEPLOYMENTS = {"tm4": dict(ports=2, tm=4), "tm3": dict(ports=2, tm=3),
               "sm4": dict(ports=4, pmi4=0), "sm4cdd": dict(ports=4, pmi4=None)}


def reference(chain, chest):
    """The JAX package's UeDl and PDSCH for the port's SmChain."""
    cell = Cell(n_prb=100, id=1, nof_ports=chain.ports)
    d = chain.dci
    jd = D.Dci2(d.rbg_bitmask, d.mcs, d.rv, d.ndi, d.harq_pid, d.tpc, d.swap, d.pinfo)
    g0, g1 = jd.grants(100)
    p = chain.pdsch
    cls = PdschSm if chain.ports == 2 else PdschSm4
    return UeDl(cell, chest_algorithm=chest), cls(cell, g0, cs.SF_IDX, cfi=cs.CFI, rnti=cs.RNTI,
                                                  pmi=p.pmi, grant1=g1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="tm4,tm3,sm4,sm4cdd")
    ap.add_argument("--start", type=float, default=26.0)
    ap.add_argument("--stop", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=cs.SM_SEED)
    ap.add_argument("--chest", default="average")
    args = ap.parse_args()
    torch.set_num_threads(4)
    for name in args.cells.split(","):
        chain = cs.SmChain(device="cpu", **DEPLOYMENTS[name])
        (b0, b1, _), rx = chain.encode(args.seed, batch=N_SF)
        ue, pdsch = reference(chain, args.chest)
        gen = torch.Generator()
        snr = args.start
        while snr >= args.stop:
            gen.manual_seed(args.seed)
            y = cs.UlChain.noisy(rx, snr, gen).numpy()
            t0 = time.perf_counter()
            grid, ce, info = ue.fft_estimate(jnp.asarray(y), cs.SF_IDX)
            (o0, ok0), (o1, ok1) = pdsch.decode2(grid, ce, info["noise"][:, 0])
            ok0, ok1 = np.asarray(ok0), np.asarray(ok1)
            right = all(np.array_equal(np.asarray(o)[k], b.numpy()[k])
                        for o, k, b in ((o0, ok0, b0), (o1, ok1, b1)))
            share = (ok0.sum() + ok1.sum()) / (2 * N_SF)
            print(f"{name} ({args.chest}) {snr:.1f} dB: TB ok {int(ok0.sum())}/{N_SF} and "
                  f"{int(ok1.sum())}/{N_SF} = {share:.3f}, passing TBs equal to the bits sent: "
                  f"{right}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if share < 0.95:
                break
            snr -= 1.0


if __name__ == "__main__":
    main()
