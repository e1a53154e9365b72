"""The JAX package's NR decode on the stimulus of `chip_smoke.py` phase 20:
where `NR_SNR_DB` comes from.

`python tests/rehearse_nr.py` (on the CPU; about a minute per point): builds
32 slots of each path's stimulus with the port on the CPU
(`chip_smoke.NrChain`: "dl" DCI 1_0 + PDSCH at mcs 27 of the qam64 table,
"dl256" mcs 27 of the qam256 table, "mimo2" NrPdsch(n_layers=2) through the
2x2 channel, "ul" NrPusch on a DCI 0_0 grant; 52 PRB), adds AWGN at each
whole dB from `--start` down (`NrChain.noisy`, noise from the path's seed), and runs
the JAX package's `NrPdsch.decode` (`NrPusch` for "ul") on it.  It prints the
TBs that pass their CRC at each point and stops below 95 %; the lowest whole
dB at or above 95 % is the path's SNR.  For "dl" the JAX package's
`NrPdcch.search` also reads the DCI back in the first slot of every point.
`--clean` instead decodes all 128 slots of each path's noise-free stimulus
(the phase's clean dispatch) and prints the TBs that pass and the slots that
fail: `NR_JAX_CLEAN`.  `--noisy` does the same for the phase's noisy
dispatch, the 128 slots with the noise the phase draws on the host at
`NR_SNR_DB`: `NR_JAX_NOISY`.

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
from srslte_tpu.phy import nr as J  # noqa: E402

N_SLOTS = 32
SEEDS = {"dl": cs.NR_SEED, "dl256": cs.NR_SEED + 1, "mimo2": cs.NR_SEED + 2,
         "ul": cs.NR_SEED + 3}


def reference(chain):
    """The JAX package's PDSCH (PUSCH) and PDCCH for the port's NrChain."""
    car = J.NrCarrier(n_prb=cs.NR_PRB, mu=0)
    p = chain.pdsch
    grant = None if p.grant is None else J.NrGrant(**{
        f: getattr(p.grant, f) for f in p.grant.__dataclass_fields__})
    cls = J.NrPusch if chain.kind == "ul" else J.NrPdsch
    pdsch = cls(car, mcs_qm=p.mcs_qm, rate=p.rate, rnti=p.rnti, slot=p.slot, grant=grant,
                n_layers=p.n_layers)
    cset = J.Coreset.full(48, duration=1)
    return pdsch, J.NrPdcch(car, cset, slot=cs.NR_SLOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="dl,dl256,mimo2,ul")
    ap.add_argument("--start", type=float, default=30.0)
    ap.add_argument("--stop", type=float, default=5.0)
    ap.add_argument("--clean", action="store_true")
    ap.add_argument("--noisy", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    for kind in args.paths.split(","):
        chain = cs.NrChain(kind, device="cpu")
        if args.clean or args.noisy:
            _, rx = chain.encode(SEEDS[kind])
            name = "clean"
            if args.noisy:
                gen = torch.Generator()
                gen.manual_seed(SEEDS[kind])
                rx, name = cs.NrChain.noisy(rx, cs.NR_SNR_DB[kind], gen), f"{cs.NR_SNR_DB[kind]} dB"
            pdsch, _ = reference(chain)
            ok = np.concatenate([np.asarray(pdsch.decode(jnp.asarray(rx[i : i + 32].numpy()))[1])
                                 for i in range(0, len(rx), 32)])
            print(f"{kind} {name}: TB ok {int(ok.sum())}/{len(ok)}, failing slots "
                  f"{np.where(~ok)[0].tolist()}", flush=True)
            continue
        _, rx = chain.encode(SEEDS[kind], batch=N_SLOTS)
        pdsch, pdcch = reference(chain)
        gen = torch.Generator()
        snr = args.start
        while snr >= args.stop:
            gen.manual_seed(SEEDS[kind])
            y = cs.NrChain.noisy(rx, snr, gen).numpy()
            t0 = time.perf_counter()
            _, ok, _ = pdsch.decode(jnp.asarray(y))
            n_ok = int(np.asarray(ok).sum())
            dci = ""
            if kind == "dl":
                hit = pdcch.search(jnp.asarray(y[0]), cs.NR_RNTI, len(chain.dci_bits),
                                   chain.locations)
                dci = f", DCI in slot 0 {'found' if hit else 'lost'}"
            print(f"{kind} {snr:.1f} dB: TB ok {n_ok}/{N_SLOTS}{dci} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if n_ok < 0.95 * N_SLOTS:
                break
            snr -= 1.0


if __name__ == "__main__":
    main()
