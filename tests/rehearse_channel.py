"""The JAX package on the stimuli of `chip_smoke.py` phases 16 and 17: where
the phases' SNRs and TB gates come from.

`python tests/rehearse_channel.py` (on the CPU; minutes per profile):

- phase 16: for each fading profile of `chip_smoke.CHANNELS`, the phase's
  128 subframes (`chip_smoke.Chain` on the CPU, the same seeds) laid end to
  end as one stream through the JAX package's `FadingChannel` with the
  phase's seed, cut back into subframes and decoded by the JAX package
  (`UeDl.fft_estimate`, `Pcfich.decode`, the PDCCH blind search over the
  phase's 18 candidates, `Pdsch.decode`; `--chest` picks the UE's channel
  estimate) in chunks of 32: the clean counts
  (CFI, DCI, TB of 128); then AWGN (the port's `awgn_power` on the CPU, the
  noise power set by the mean power of all 128 subframes, as the phase sets
  it) on the first 32 subframes at each whole dB from `--start` down, until
  fewer than 95 % of the 32 TBs pass: the lowest whole dB at or above 95 %
  is the profile's SNR, then decoded on all 128 subframes; for EPA5 also
  the RLF and delay stream;
- phase 17 (`--rails`): stream A of phase 12 (`chip_smoke.blind_capture` on
  the CPU) through the JAX package's `apply_hst` (the second of two runs)
  and `fractional_delay`, the `resample_fft` round trip per subframe that
  the pipe radio makes (30.72 -> 23.04 -> 30.72 Msps), -30 dB and
  `Agc.process`, then the JAX package's `examples/pdsch_ue.receive`: the DCI
  and TB counts phase 17 is gated against (`chip_smoke.RAILS_JAX`); and the
  JAX package's `resample_arb` on phase 17's tone (`chip_smoke.ARB_JAX_EVM`).

Not a test (pytest does not collect it): full-width runs of the JAX package
take minutes on the CPU.
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
from srslte_tpu.phy.agc import Agc  # noqa: E402
from srslte_tpu.phy.channel import FadingChannel, fractional_delay, rlf_mask  # noqa: E402
from srslte_tpu.phy.channel.hst import apply_hst  # noqa: E402
from srslte_tpu.phy.common.params import Cell  # noqa: E402
from srslte_tpu.phy.phch.dci import Dci1A, format0_1a_size, pack_format1a  # noqa: E402
from srslte_tpu.phy.phch.pcfich import Pcfich  # noqa: E402
from srslte_tpu.phy.phch.pdcch import (Pdcch, common_locations, rnti_mask,  # noqa: E402
                                       ue_locations)
from srslte_tpu.phy.phch.pdsch import Pdsch  # noqa: E402
from srslte_tpu.phy.resampling import resample_fft  # noqa: E402
from srslte_tpu.phy.ue.ue_dl import UeDl  # noqa: E402
from srslte_tpu_torch.phy.channel import awgn_power  # noqa: E402

CHUNK = 32


class Reference:
    """The JAX package's side of `chip_smoke.Chain.receive`."""

    def __init__(self, mcs, chest):
        self.cell = Cell(n_prb=100, id=1, nof_ports=1)
        dci = Dci1A(rb_start=0, l_crb=100, mcs=mcs)
        self.pdsch = Pdsch(self.cell, dci.grant(100), cs.SF_IDX, cfi=cs.CFI, rnti=cs.RNTI)
        self.ue = UeDl(self.cell, chest_algorithm=chest)
        self.pcfich = Pcfich(self.cell, cs.SF_IDX)
        self.pd = Pdcch(self.cell, cs.CFI, cs.SF_IDX)
        locs = ue_locations(self.pd.n_cce, cs.RNTI, cs.SF_IDX)
        locs += [l for l in common_locations(self.pd.n_cce) if l not in locs]
        groups = {}
        for l in locs:
            groups.setdefault(l.L, []).append(l)
        self.groups = tuple(tuple(g) for g in groups.values())
        self.mask = jnp.asarray(rnti_mask(cs.RNTI))
        self.dci_bits = np.asarray(pack_format1a(dci, 100))
        self.dci_len = format0_1a_size(100)

    def decode(self, rx, bits):
        """rx [n, 30720] numpy -> per subframe (CFI ok, DCI ok, TB ok, false
        CRC hits), in chunks of CHUNK subframes; checks every passing TB."""
        out = []
        for i in range(0, len(rx), CHUNK):
            grid, ce, info = self.ue.fft_estimate(jnp.asarray(rx[i:i + CHUNK]), cs.SF_IDX)
            cfi, _ = self.pcfich.decode(grid, ce)
            ok, cand = self.pd._decode_mixed_traced(grid, ce, self.groups, self.dci_len,
                                                    self.mask)
            ok, cand = np.asarray(ok), np.asarray(cand)
            match = np.all(cand == self.dci_bits, axis=-1)
            dec, tb = self.pdsch.decode(grid, ce, info["noise"])
            dec, tb = np.asarray(dec), np.asarray(tb)
            assert np.array_equal(dec[tb], bits[i:i + CHUNK][tb]), "a passing TB differs"
            out.append(np.stack([np.asarray(cfi) == cs.CFI, np.any(ok & match, -1), tb,
                                 (ok & ~match).sum(-1)], -1))
        return np.concatenate(out)


def noisy(x, ref_power, snr_db, seed):
    """x plus AWGN of power ref_power / snr (the port's awgn_power, CPU)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return awgn_power(gen, torch.as_tensor(x), ref_power / 10 ** (snr_db / 10)).numpy()


def channel(name, start, chest=None):
    profile, fd, mcs, est, _ = cs.CHANNELS[name]
    chest = chest or est
    chain = cs.Chain(mcs=mcs, chest=chest, device="cpu")
    bits, s = chain.encode(cs.CHANNEL_SEED)
    bits, s = bits.numpy(), s.numpy()
    ch = FadingChannel(profile, fd, cs.CHANNEL_SRATE, seed=cs.FADING_SEED)
    faded = np.asarray(ch(jnp.asarray(s.reshape(-1)))).reshape(s.shape)
    ref = Reference(mcs, chest)
    p = float(np.mean(np.abs(faded) ** 2))
    label = f"{name} mcs {mcs} ({chest})"
    t0 = time.perf_counter()
    c = ref.decode(faded, bits)
    print(f"{label} clean: CFI {int(c[:, 0].sum())}, DCI {int(c[:, 1].sum())}, TB "
          f"{int(c[:, 2].sum())} of {len(c)}, false CRC hits {int(c[:, 3].sum())}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    snr, found = start, None
    while snr >= 0:
        c = ref.decode(noisy(faded[:CHUNK], p, snr, cs.CHANNEL_SEED), bits[:CHUNK])
        share = c[:, 2].mean()
        print(f"{label} {snr:.0f} dB, first {CHUNK} subframes: TB ok {int(c[:, 2].sum())}/"
              f"{CHUNK} = {share:.3f}, DCI {int(c[:, 1].sum())}, false CRC hits "
              f"{int(c[:, 3].sum())}", flush=True)
        if share < 0.95:
            break
        found, snr = snr, snr - 1
    if found is None:
        print(f"{label}: below 95 % at {start} dB", flush=True)
        return
    c = ref.decode(noisy(faded, p, found, cs.CHANNEL_SEED), bits)
    print(f"{label} SNR {found} dB: all {len(c)} subframes: CFI {int(c[:, 0].sum())}, DCI "
          f"{int(c[:, 1].sum())}, TB {int(c[:, 2].sum())}, false CRC hits "
          f"{int(c[:, 3].sum())}", flush=True)
    if name == "epa5" and chest == est:
        mask = np.asarray(rlf_mask(faded.size, cs.CHANNEL_SRATE, cs.RLF_ON_MS, cs.RLF_OFF_MS))
        x = np.asarray(fractional_delay(jnp.asarray(faded.reshape(-1)), cs.CHANNEL_DELAY)) * mask
        x = x.reshape(s.shape)
        on = mask.reshape(s.shape).all(-1)
        off = ~mask.reshape(s.shape).any(-1)
        c = ref.decode(noisy(x, float(np.mean(np.abs(x) ** 2)), found, cs.CHANNEL_SEED), bits)
        print(f"{label} delay {cs.CHANNEL_DELAY} + RLF {cs.RLF_ON_MS}/{cs.RLF_OFF_MS} ms at "
              f"{found} dB: {int(on.sum())} on-subframes TB {int(c[on, 2].sum())}, false CRC hits "
              f"{int(c[on, 3].sum())}; {int(off.sum())} off-subframes DCI {int(c[off, 1].sum())}, "
              f"TB {int(c[off, 2].sum())}, CRC hits {int(c[off, 3].sum())}", flush=True)


def rails():
    from examples.pdsch_ue import receive
    from srslte_tpu_torch.phy.common.params import Cell as TCell

    cell = TCell(n_prb=cs.BLIND_PRB, id=cs.BLIND_CELL_ID, nof_ports=1)
    a, bits, _, _ = cs.blind_capture(cell, device="cpu")
    sf_len = cell.ofdm.sf_len
    for name, hst in (("rails", False), ("rails_hst", True)):
        x = jnp.asarray(a)
        if hst:
            x = apply_hst(x, cs.CHANNEL_SRATE, t0=cs.HST_T0, **cs.HST)
        x = fractional_delay(x, cs.HST_DELAY).reshape(-1, sf_len)
        x = np.asarray(resample_fft(resample_fft(x, 3, 4), 4, 3)).reshape(-1)
        x = x * np.float32(10 ** (cs.AGC_SCALE_DB / 20))
        y, _, _ = Agc(target=cs.AGC_TARGET).process(jnp.asarray(x.astype(np.complex64)), sf_len)
        y = np.asarray(y)
        rms = np.sqrt(np.mean(np.abs(y[-4 * sf_len:]) ** 2))
        out = cs.blind_receive(y, receive)
        res = out["results"]
        ok = [r for r in res if r["crc_ok"]]
        equal = all(np.array_equal(r["bits"], bits[r["sf_idx"]]) for r in ok)
        print(f"{name}: AGC RMS of the last 4 frames {rms:.4f}; cell "
              f"{out['cell'].id if out['cell'] else None}, {out['mib']}; {len(res)} subframes, "
              f"DCI {sum(r['dci'] is not None for r in res)} "
              f"({''.join(str(int(r['dci'] is not None)) for r in res)}), CFI 2 in "
              f"{sum(r['cfi'] == 2 for r in res)}, TB ok {len(ok)} (CRC per subframe "
              f"{''.join(str(int(r['crc_ok'])) for r in res)}), passing TBs equal to the bits "
              f"sent: {equal}", flush=True)


def arb():
    """The JAX package's resample_arb on phase 17's tone, one frame."""
    from srslte_tpu.phy.resampling import resample_arb

    nf = 10 * 30720
    x = np.exp(2j * np.pi * cs.ARB_TONE * np.arange(nf)).astype(np.complex64)
    for rate in (cs.ARB_RATE, cs.ARB_TEST_RATE):
        y = np.asarray(resample_arb(jnp.asarray(x), rate, interpolate=True))
        print(f"resample_arb rate {rate:.6g}: tone EVM {cs.tone_evm(y, cs.ARB_TONE / rate):.6f}",
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles", default=",".join(cs.CHANNELS))
    ap.add_argument("--start", type=float, default=30.0)
    ap.add_argument("--chest", default=None,
                    help="the channel estimate of every profile (default: each profile's own)")
    ap.add_argument("--rails", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(2)
    for name in filter(None, args.profiles.split(",")):
        channel(name, args.start, args.chest)
    if args.rails:
        arb()
        rails()


if __name__ == "__main__":
    main()
