"""The JAX package on the stimuli of `chip_smoke.py` phase 22: where `NB_JAX`
and `NB_SNR_DB` come from.

`python tests/rehearse_nbiot.py` (on the CPU; a few minutes):

- 22a: the port's `examples/npdsch_enodeb.generate` on the CPU (8 frames,
  the example's defaults), impaired by `chip_smoke.nb_impair`, through the
  JAX package's `examples/npdsch_ue.py` `receive`; prints the counts the
  phase gates on (cell, MIB, DCIs, TBs equal to the bits sent).  Then the
  JAX example pair alone, clean, at I_SF 0-3 (`--isf`): the example puts
  the NPDSCH in subframes 3 onward and `NbEnbDl.frame_grids` never writes
  data into subframe 5 (the NPSS), so a grant of more than 2 subframes
  cannot decode (ROADMAP queue C).
- 22b: `chip_smoke.nb_long_samples` built by the port on the CPU (TBS 680
  over 10 subframes, 2 NRS ports and 1), decoded by the JAX package
  (`UeDlNbiot.fft_estimate` per subframe, then `Npdsch(nof_ports=2).decode`,
  or `UeDlNbiot.decode_npdsch` for 1 port, as `chip_smoke.nb_long_decode`),
  clean and at each whole dB from `--start` down: the lowest whole dB at
  which at least 95 % of the 32 TBs pass is `NB_SNR_DB`; the indices of
  the TBs lost clean and there are `NB_JAX`.  It also decodes the 2-port stimulus
  through `UeDlNbiot.decode_npdsch`, which builds a 1-port `Npdsch`.

Not a test (pytest does not collect it).
"""

import argparse
import importlib.util
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
from srslte_tpu.phy.nbiot.npdsch import NbDlGrant, Npdsch  # noqa: E402
from srslte_tpu.phy.nbiot.ue import UeDlNbiot  # noqa: E402
from srslte_tpu_torch.examples import npdsch_enodeb  # noqa: E402


def example(name):
    """The JAX package's examples/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_long_decode(x, nof_ports, via_ue=False):
    """`chip_smoke.nb_long_decode` on the JAX package -> crc ok [B], bits."""
    grant = NbDlGrant(*cs.NB_LONG)
    sf_nf = cs.nb_long_sf_nf()
    ue = UeDlNbiot(cs.NB_ID)
    oks, bits = [], []
    for b in range(x.shape[0]):
        est = [ue.fft_estimate(jnp.asarray(x[b, i]), s) for i, (s, _) in enumerate(sf_nf)]
        grids = jnp.stack([g for g, _, _ in est])
        ces = jnp.stack([c for _, c, _ in est])
        if nof_ports == 2 and not via_ue:
            out, ok = Npdsch(cs.NB_ID, grant, cs.NB_RNTI, nof_ports=2).decode(grids, ces, sf_nf)
        else:
            out, ok = ue.decode_npdsch(grids, ces, sf_nf, grant, cs.NB_RNTI)
        oks.append(bool(np.asarray(ok)))
        bits.append(np.asarray(out))
    return np.array(oks), np.stack(bits)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=float, default=-7.0)
    ap.add_argument("--stop", type=float, default=-14.0)
    ap.add_argument("--isf", default="0,1,2,3")
    args = ap.parse_args()
    torch.set_num_threads(2)
    ue_ex, enb_ex = example("npdsch_ue"), example("npdsch_enodeb")

    t0 = time.perf_counter()
    sig = npdsch_enodeb.generate(cs.NB_ID, cs.NB_RNTI, cs.NB_FRAMES, 5, 1, device="cpu")
    x = cs.nb_impair(sig, *cs.NB_IMPAIR)
    out = ue_ex.receive(x, cs.NB_RNTI)
    print(f'22a: "example": {cs.nb_example_score(out)} (cell, MIB, DCIs, TBs equal to the bits '
          f'sent) in {time.perf_counter() - t0:.0f} s', flush=True)
    for i_sf in (map(int, args.isf.split(",")) if args.isf else ()):
        sig = enb_ex.generate(cs.NB_ID, cs.NB_RNTI, 4, 5, i_sf)
        out = ue_ex.receive(sig, cs.NB_RNTI)
        print(f"JAX example pair, I_SF {i_sf} (data in subframes 3-"
              f"{2 + NbDlGrant(5, i_sf).nof_sf}): CRC {[r['crc_ok'] for r in out['results']]}",
              flush=True)

    for nof_ports in (2, 1):
        t0 = time.perf_counter()
        bits, x = cs.nb_long_samples(cs.nb_port(), nof_ports, "cpu")
        ok, got = jax_long_decode(x, nof_ports)
        check_bits = all(np.array_equal(g, b) for g, b, o in zip(got, bits, ok) if o)
        print(f"22b {nof_ports} port(s), clean: {int(ok.sum())}/{cs.NB_TBS} TBs, lost "
              f"{tuple(np.flatnonzero(~ok).tolist())} (bits equal: {check_bits}) in "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
        if nof_ports == 2:
            ok_ue, _ = jax_long_decode(x, 2, via_ue=True)
            print(f"22b 2 ports through UeDlNbiot.decode_npdsch (a 1-port Npdsch), clean: "
                  f"{int(ok_ue.sum())}/{cs.NB_TBS} TBs", flush=True)
        snr = args.start
        while snr >= args.stop:
            ok, got = jax_long_decode(cs.nb_long_noisy(x, snr, cs.NB_SEED), nof_ports)
            n = int(ok.sum())
            print(f"22b {nof_ports} port(s), {snr} dB: {n}/{cs.NB_TBS} TBs, lost "
                  f"{tuple(np.flatnonzero(~ok).tolist())}", flush=True)
            if n < 0.95 * cs.NB_TBS:
                break
            snr -= 1.0


if __name__ == "__main__":
    main()
