"""The JAX package on the scenarios of `chip_smoke.py` phase 21: where
`NR_STACK_JAX` comes from.

`python tests/rehearse_nr_stack.py [harq] [stack] [vnf]` (on the CPU; minutes
per scenario, most of it XLA compiling): runs `chip_smoke.nr_stack_scenario`
("harq": 8 TBs at 10.5 dB with PUCCH ACK/NACK, "stack": 16 ciphered packets
through PDCP / RLC UM / MAC at 16 dB) and `chip_smoke.nr_vnf_scenario` on
the JAX package's workers, stacks and VNF at 52 PRB, with the noise the
phase draws on the host from the same seeds, and prints what the phase
gates on: per slot (pid, rv, ACK as the gNB decodes it), the slots that
delivered a TB, the retransmissions, the gates, and the slots whose LDPC
code blocks did not all converge (where the phase may allow a slack, ROADMAP
queue C item 18).  `--snr-scan` first decodes rv 0 alone of the "harq" TBs at
10.5 dB and at each whole dB below, and prints the share that fails.

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
from srslte_tpu import nr_stack, nr_worker, vnf  # noqa: E402
from srslte_tpu.phy.nr import Coreset, NrCarrier  # noqa: E402
from srslte_tpu.phy.nr import dlsch_nr  # noqa: E402


def noisy(grid, sigma, gen):
    """`chip_smoke.nr_stack_port`'s noise, the same draws, added in complex64."""
    n = (torch.randn((2,) + tuple(grid.shape), generator=gen) * sigma).numpy()
    c = np.empty(n.shape[1:], np.complex64)
    c.real, c.imag = n[0], n[1]
    return jnp.asarray(np.asarray(grid) + c)


PKG = cs.types.SimpleNamespace(
    NrCarrier=NrCarrier, Coreset=Coreset, NrWorkerCommon=nr_worker.NrWorkerCommon,
    GnbNrWorker=nr_worker.GnbNrWorker, UeNrWorker=nr_worker.UeNrWorker,
    GnbNrStack=nr_stack.GnbNrStack, UeNrStack=nr_stack.UeNrStack, vnf=vnf, noisy=noisy)


def converged_recorder(record):
    """Wrap dlsch_nr.ldpc_decode: each decode appends whether every code
    block's parity checks held."""
    fn = dlsch_nr.ldpc_decode

    def call(w, graph, n_iter=8):
        hard, ok_pc = fn(w, graph, n_iter=n_iter)
        record.append(bool(np.all(np.asarray(ok_pc))))
        return hard, ok_pc
    return call


def within_maps(label, fn, *args):
    """`call` for the scenarios: XLA on the CPU keeps every executable it
    compiles mapped, and a slot of the eager JAX receiver compiles about
    5,400 mappings' worth (most of them the list decoder's operations), so a
    run of 16 slots passes the kernel's 65,530 mappings and LLVM fails with
    "Cannot allocate memory".  The caches are dropped before that."""
    out = fn(*args)
    with open("/proc/self/maps") as f:
        if sum(1 for _ in f) > 40000:
            jax.clear_caches()
    return out


def snr_scan():
    """rv 0 alone of the "harq" TBs: the share that fails at each dB."""
    common, gnb, ue = cs.nr_stack_workers(PKG)
    rng = np.random.default_rng(cs.NRS_SEEDS["harq"])
    sent = [rng.integers(0, 2, cs.NRS_TBS).astype(np.uint8) for _ in range(cs.NRS_HARQ_TBS)]
    for snr in (10.5, 10.0, 9.0, 8.0):
        gen = torch.Generator()
        gen.manual_seed(cs.NRS_SEEDS["harq"])
        sigma = 10 ** (-snr / 20) / np.sqrt(2)
        fails = 0
        for i, bits in enumerate(sent):
            g = nr_worker.GnbNrWorker(common)
            g.tx_data(bits)
            grid = g.tx_slot(i % 2)
            u = nr_worker.UeNrWorker(common)
            within_maps("rx_slot", u.rx_slot, noisy(grid, sigma, gen), i % 2)
            fails += not u.delivered
        print(f"rv 0 alone at {snr} dB: {fails}/{len(sent)} TBs fail", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", default=["harq", "stack", "vnf"])
    ap.add_argument("--snr-scan", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.snr_scan:
        snr_scan()
    for name in args.names:
        t0 = time.perf_counter()
        if name == "vnf":
            out = cs.nr_vnf_scenario(PKG, within_maps)
            print(f"{name}: {out} in {time.perf_counter() - t0:.0f} s", flush=True)
            continue
        record = []
        saved = dlsch_nr.ldpc_decode
        dlsch_nr.ldpc_decode = converged_recorder(record)
        try:
            out = cs.nr_stack_scenario(name, PKG, within_maps)
        finally:
            dlsch_nr.ldpc_decode = saved
        busy = [i for i, t in enumerate(out["timeline"]) if t is not None]
        open_slots = tuple(s for s, c in zip(busy, record) if not c)
        print(f"{name}: {time.perf_counter() - t0:.0f} s", flush=True)
        print(f'    "{name}": {{"timeline": {out["timeline"]},', flush=True)
        print(f'             "delivered_at": {out["delivered_at"]}, "n_retx": {out["n_retx"]}}},')
        print(f"    gates {out['gates']}; dropped {out['dropped']}, slots {out['slots']}; "
              f"slots whose LDPC blocks did not all converge: {open_slots}", flush=True)


if __name__ == "__main__":
    main()
