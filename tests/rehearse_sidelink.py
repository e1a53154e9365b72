"""The JAX package on the stimuli of `chip_smoke.py` phase 23: where
`SL_SNR_DB` and `SL_JAX` come from.

`python tests/rehearse_sidelink.py` (on the CPU; about 10 minutes): the
port builds 23b's and 23c's subframes on the CPU (`chip_smoke.sl_stimulus`:
the SCI-0 on the PSCCH and its PSSCH at 50 PRB, mcs 20), and
`chip_smoke.sl_channel` puts them through the flat channel with AWGN drawn
on the host, the grids the phase decodes on the card.  The JAX package
receives them as tests/test_sidelink.py's control/data flow does: the SCI
from the PSCCH of each subframe, then the PSSCH the SCI describes (decoded
in one batch per subframe index, whose TBs the decoder treats one by one).

- from `--start` down, each whole dB: the TBs of the first 32 subframes of
  23b's stimulus that pass; the lowest whole dB with >= 95 % is
  `SL_SNR_DB`;
- at `SL_SNR_DB`: the indices of the TBs the JAX package loses of 23b's
  128 subframes and of 23c's 128 (one subframe index): `SL_JAX`.

It prints counts and indices, never a time.  Not a test (pytest does not
collect it).
"""

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from srslte_tpu.phy.phch.ra import riv_type2_decode  # noqa: E402
from srslte_tpu.phy.sidelink import Pscch, Pssch, Sci0  # noqa: E402


def jax_receive(rx, sfs, bits):
    """The JAX package's receive of subframes rx [n, 14, 600] (numpy) with
    subframe indices sfs -> TB ok [n] (the SCI right, the CRC passing and
    the bits equal to those sent)."""
    want = Sci0(**{f: getattr(cs.sl_sci(), f) for f in cs.sl_sci().__dataclass_fields__})
    pscch = Pscch(cs.SL_PRB, *cs.SL_PSCCH)
    ok = np.zeros(len(rx), bool)
    groups = {}
    for i in range(len(rx)):
        sci = pscch.decode(jnp.asarray(rx[i]))
        if sci != want:
            print(f"  subframe {i}: SCI {sci}", flush=True)
            continue
        rb0, l_rb = riv_type2_decode(cs.SL_PRB, sci.riv)
        groups.setdefault((int(sfs[i]), rb0, l_rb, sci.group_dst_id, sci.mcs), []).append(i)
    for (sf, rb0, l_rb, n_x_id, mcs), idx in groups.items():
        out, crc = Pssch(cs.SL_PRB, rb0, l_rb, n_x_id=n_x_id, sf_idx=sf, mcs=mcs).decode(
            jnp.asarray(rx[idx]))
        ok[idx] = np.asarray(crc) & (np.asarray(out) == bits[idx]).all(-1)
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=float, default=15.0)
    a = ap.parse_args()
    torch.set_num_threads(4)
    stim = {name: cs.sl_stimulus(name, "cpu") for name in ("sf", "batch")}

    def rx_at(name, snr):
        return cs.sl_channel(stim[name][2], cs.sl_sigma(snr), cs.SL_SEEDS[name] + 1000)

    sfs, bits, _ = stim["sf"]
    snr, best = a.start, None
    while True:
        ok = jax_receive(rx_at("sf", snr)[:32], sfs[:32], bits.numpy()[:32])
        print(f"{snr:g} dB: {int(ok.sum())}/32 TBs", flush=True)
        if ok.mean() < 0.95:
            break
        best = snr
        snr -= 1.0
    if best is None:
        raise SystemExit(f"already below 95 % at --start {a.start}: start higher")
    print(f"SL_SNR_DB = {best:g}")
    lost = {}
    for name in ("sf", "batch"):
        s, b, _ = stim[name]
        ok = jax_receive(rx_at(name, best), s, b.numpy())
        lost[name] = tuple(np.flatnonzero(~ok).tolist())
        print(f"{name}: {int(ok.sum())}/{len(ok)} TBs at {best:g} dB, lost {lost[name]}",
              flush=True)
        ok = jax_receive(cs.sl_channel(stim[name][2], None, 0), s, b.numpy())
        print(f"{name}: {int(ok.sum())}/{len(ok)} TBs clean", flush=True)
    print(f"SL_JAX = {lost}")


if __name__ == "__main__":
    main()
