#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Builds the two hand-written CUDA kernels from `srslte_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, then drives the port's
main path, the 20 MHz UE downlink receive chain at the srsUE cc_worker scope,
through the entry points a user would call:

    eNB encode (stimulus) -> AWGN -> UeDl.fft_estimate -> Pcfich.decode ->
    Pdcch blind search (18 candidates) -> Pdsch.decode (turbo cascade)

at the deployment's full width: 100 PRB, 1 port, normal CP, CFI 2, subframe 4,
DCI 1A at Location(8, 8) for RNTI 0x46, PDSCH over all 100 PRB at mcs 27
(64QAM), in batches of 128 subframes, clean and at 16 dB time-domain SNR.

Exits non-zero on any failure, and when there is no CUDA device.  The line
before the last is the card's name and power limit; the last line is
`{"ok": true, "device": {...}}`.

`python3 chip_smoke.py --profile` adds one dispatch under `torch.profiler`
after phase 5 and prints the device's busy share and the kernels that take
most of its time.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

REALTIME_MSPS = 30.72  # 100 PRB real-time sample rate
SNR_DB = 16.0
CFI = 2
RNTI = 0x46
SF_IDX = 4
BATCH = 128
N_TIMED = 10  # the host clock of a shared machine has outliers: report the median

# Published peaks of one H100 SXM (NVIDIA data sheet): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def event_ms(fn, n):
    """Mean device time of fn() over n calls, by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# ------------------------------------------------------------------ phases
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[1 device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    return smi


def phase_build():
    from srslte_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(force=True)
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 build] {name}: {line.strip()}")
    print(f"[2 build] {len(logs)} kernels built with nvcc in {dt:.1f} s (set-up time)", flush=True)
    check(set(logs) == set(_build.SOURCES), "a kernel source was not built")


def turbo_siso_inputs(rng, B, K, snr_db=1.5):
    """Realistic SISO inputs on the card: random blocks turbo-encoded (on the
    card), BPSK + AWGN from numpy -> (sys, par1, beta_init)."""
    from srslte_tpu_torch.phy.fec import tdec, turbo

    bits = rng.integers(0, 2, (B, K)).astype(np.uint8)
    coded = turbo.turbo_encode(bits, K).to(torch.float32)
    sigma = 10 ** (-snr_db / 20)
    noise = torch.as_tensor(rng.standard_normal(coded.shape, dtype=np.float32), device=coded.device)
    llr = -((1 - 2 * coded) + sigma * noise) * (2 / sigma**2)
    sys_, par1, _, (t1x, t1z), _ = tdec._split_dcat(llr, K)
    return sys_.contiguous(), par1.contiguous(), tdec._tail_beta(t1x, t1z)


def phase_kernels():
    """Each kernel against its plain version on the card; returns the
    measurements of the `kernels` line (without the launch counts)."""
    from srslte_tpu_torch.ops import tdec_cuda, viterbi_cuda
    from srslte_tpu_torch.phy.fec import convolutional, turbo

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    # --- SISO ------------------------------------------------------------
    siso_err = 0.0
    main_inputs = None
    for (B, K, L, T) in ((64, 40, 8, 4), (64, 1024, 128, 32), (BATCH * 11, 5824, 256, 32)):
        sys_, par, b0 = turbo_siso_inputs(rng, B, K)
        pi = torch.as_tensor(turbo.qpp_perm(K).astype(np.int32), device=dev)
        variants = [(False, None)] if K != 5824 else [
            (False, None), (True, None), (False, pi), (True, pi)]
        for emit_ext, perm in variants:
            got = tdec_cuda.siso_windowed(sys_, par, b0, L, T, emit_ext=emit_ext, perm=perm)
            ref = tdec_cuda.siso_windowed_plain(sys_, par, b0, L, T, emit_ext=emit_ext, perm=perm)
            torch.cuda.synchronize()
            # tolerance: 1e-4 of the LLR scale; hard decisions equal beyond it
            full = ref + (sys_[:, perm.long()] if perm is not None else sys_) if emit_ext else ref
            tol = 1e-4 * float(full.abs().max())
            err = float((got - ref).abs().max())
            check(bool(torch.isfinite(got).all()), f"SISO K={K}: non-finite output")
            check(err <= tol, f"SISO K={K} L={L} T={T} ext={emit_ext} perm={perm is not None}: "
                              f"max abs diff {err} > {tol}")
            sure = ref.abs() > tol
            check(bool(((got > 0) == (ref > 0))[sure].all()), f"SISO K={K}: hard decisions differ")
            siso_err = max(siso_err, err)
            print(f"[3 kernels] siso_windowed B={B} K={K} L={L} T={T} emit_ext={emit_ext} "
                  f"perm={perm is not None}: max abs diff {err:.3g} (tolerance {tol:.3g})")
        if K == 5824:
            main_inputs = (sys_, par, b0, pi, L, T)

    sys_, par, b0, pi, L, T = main_inputs
    B, K = sys_.shape
    ms_nat = event_ms(lambda: tdec_cuda.siso_windowed(sys_, par, b0, L, T, emit_ext=True), 10)
    ms_perm = event_ms(lambda: tdec_cuda.siso_windowed(sys_, par, b0, L, T, emit_ext=True,
                                                       perm=pi), 10)
    plain_ms = event_ms(lambda: tdec_cuda.siso_windowed_plain(sys_, par, b0, L, T,
                                                              emit_ext=True, perm=pi), 1)
    W = -(-K // L)
    # bytes: sys, par, out [B, K] float32, beta_init [B, 8], perm [K] int32,
    # each once; operations: per window T+L alpha steps (1 add for gamma, 16
    # adds, 8 max), T+L beta steps (16 adds, 8 max), L LLRs (16 adds, 14 max,
    # 2 subtractions)
    siso_bytes = 3 * B * K * 4 + B * 8 * 4 + K * 4
    siso_ops = B * W * ((T + L) * (25 + 24) + L * 32)
    siso = {"name": "siso_windowed", "route": "cuda",
            "source": "srslte_tpu_torch/csrc/tdec_siso.cu",
            "replaces": "srslte_tpu/ops/tdec_pallas.py:98",
            "max_abs_err": siso_err, "ms": (ms_nat + ms_perm) / 2, "plain_ms": plain_ms,
            "library_ms": None, "_bytes": siso_bytes, "_ops": siso_ops,
            "_detail": f"B={B} K={K} L={L} T={T} emit_ext: {ms_nat:.3f} ms without perm, "
                       f"{ms_perm:.3f} ms with perm"}

    # --- Viterbi ---------------------------------------------------------
    nc = BATCH * 18
    vit_err = 0
    main_llr = None
    for length in (44, 27):
        bits = rng.integers(0, 2, (nc, length)).astype(np.uint8)
        coded = convolutional.conv_encode(bits, length).to(torch.float32)
        for tail_biting in (True, False):
            # clean, noisy, and clean with the last 8 steps erased (LLR 0): there
            # every end state ties, which is what tells the first maximum from
            # another, and every decision of those steps is a tie
            for kind, sigma in (("clean", 0.0), ("noisy", 0.8), ("erased tail", 0.0)):
                noise = torch.as_tensor(rng.standard_normal(coded.shape, dtype=np.float32),
                                        device=dev)
                llr = (-(1 - 2 * coded) + sigma * noise).contiguous()
                if kind == "erased tail":
                    llr[:, -24:] = 0.0
                got = viterbi_cuda.viterbi_decode(llr, length, tail_biting)
                ref = viterbi_cuda.viterbi_decode_plain(llr, length, tail_biting)
                torch.cuda.synchronize()
                nbad = int((got != ref).sum())
                check(nbad == 0, f"Viterbi len={length} tail_biting={tail_biting} {kind}: "
                                 f"{nbad} bits differ from the plain version")
                if tail_biting and kind != "erased tail":
                    ber = float((got.cpu().numpy() != bits).mean())
                    check(ber < (1e-9 if kind == "clean" else 1e-2),
                          f"Viterbi len={length} {kind}: BER {ber}")
                vit_err = max(vit_err, nbad)
                print(f"[3 kernels] viterbi_decode B={nc} len={length} tail_biting={tail_biting} "
                      f"{kind}: bits equal to the plain version")
                if length == 44 and tail_biting and kind == "noisy":
                    main_llr = llr
    ms = event_ms(lambda: viterbi_cuda.viterbi_decode(main_llr, 44, True), 20)
    plain_ms = event_ms(lambda: viterbi_cuda.viterbi_decode_plain(main_llr, 44, True), 1)
    steps = 3 * 44
    # bytes: llr [B, 132] float32 in, bits [B, 44] uint8 out; operations per
    # candidate and step: 10 for the 8 branch metrics, 64 x (2 adds, 1 max,
    # 1 compare); traceback 3 integer operations per step
    vit_bytes = nc * 132 * 4 + nc * 44
    vit_ops = nc * steps * (10 + 64 * 4 + 3)
    vit = {"name": "viterbi_decode", "route": "cuda",
           "source": "srslte_tpu_torch/csrc/viterbi.cu",
           "replaces": "srslte_tpu/ops/viterbi_pallas.py:58",
           "max_abs_err": float(vit_err), "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "_bytes": vit_bytes, "_ops": vit_ops,
           "_detail": f"B={nc} len=44 tail-biting (132 steps)"}
    for k in (siso, vit):
        by, op = k.pop("_bytes") / HBM_BYTES_PER_S * 1e3, k.pop("_ops") / FP32_OPS_PER_S * 1e3
        k["bound_ms"], k["bound_by"] = max(by, op), "bytes" if by >= op else "operations"
        print(f"[3 kernels] {k['name']} at the main path's shape ({k.pop('_detail')}): "
              f"{k['ms']:.3f} ms/launch, plain version {k['plain_ms']:.1f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} ({by:.4f} ms bytes, {op:.4f} ms "
              f"operations); no single PyTorch call computes this", flush=True)
    return [siso, vit]


class Chain:
    """The deployment's objects and the two sides of the main path."""

    def __init__(self):
        from srslte_tpu_torch.phy.common.params import Cell
        from srslte_tpu_torch.phy.enb.enb_dl import EnbDl
        from srslte_tpu_torch.phy.phch.dci import Dci1A, format0_1a_size, pack_format1a
        from srslte_tpu_torch.phy.phch.pcfich import Pcfich
        from srslte_tpu_torch.phy.phch.pdcch import (Location, Pdcch, common_locations,
                                                     rnti_mask, ue_locations)
        from srslte_tpu_torch.phy.phch.pdsch import Pdsch
        from srslte_tpu_torch.phy.ue.ue_dl import UeDl

        self.cell = Cell(n_prb=100, id=1, nof_ports=1)
        self.dci = Dci1A(rb_start=0, l_crb=100, mcs=27)
        self.grant = self.dci.grant(100)
        self.pdsch = Pdsch(self.cell, self.grant, SF_IDX, cfi=CFI, rnti=RNTI)
        self.enb = EnbDl(self.cell)
        self.ue = UeDl(self.cell)
        self.pcfich = Pcfich(self.cell, SF_IDX)
        self.pd = Pdcch(self.cell, CFI, SF_IDX)
        self.dci_bits = pack_format1a(self.dci, 100)
        self.dci_len = format0_1a_size(100)
        self.tx_loc = Location(8, 8)  # inside the UE search space for RNTI 0x46 @ sf 4
        # full blind-search candidate set: UE-specific + common (cc_worker scope)
        locs = ue_locations(self.pd.n_cce, RNTI, SF_IDX)
        locs += [l for l in common_locations(self.pd.n_cce) if l not in locs]
        check(self.tx_loc in locs and len(locs) == 18, "unexpected PDCCH candidate set")
        groups = {}
        for l in locs:
            groups.setdefault(l.L, []).append(l)
        self.groups = tuple(tuple(g) for g in groups.values())
        self.mask = torch.as_tensor(rnti_mask(RNTI), device="cuda")
        self.dci_bits_t = torch.as_tensor(self.dci_bits, device="cuda")
        cfg = self.pdsch.cfg
        check((cfg.tbs, cfg.G, cfg.seg.C) == (63776, 82800, 11), "unexpected DL-SCH bucket")
        check(self.cell.ofdm.sf_len == 30720, "unexpected subframe length")

    def encode(self, seed):
        """BATCH subframes of stimulus: (bits [B, tbs] on the card, samples [B, sf_len])."""
        rng = np.random.default_rng(seed)
        bits = torch.as_tensor(rng.integers(0, 2, (BATCH, self.grant.tbs), dtype=np.uint8),
                               device="cuda")
        g = self.enb.put_base(self.enb.empty_grids((BATCH,)), SF_IDX)
        g = self.enb.put_pcfich(g, SF_IDX, CFI)
        g = self.enb.put_pdcch(g, SF_IDX, CFI, self.dci_bits, RNTI, self.tx_loc)
        g = self.enb.put_pdsch(g, self.pdsch, bits)
        return bits, self.enb.gen_signal(g)[..., 0, :]

    def decode(self, s, snr_db, gen, stages=None):
        """One dispatch of the receive chain on BATCH subframes; noise is
        drawn anew from `gen` (none for snr_db None).  Returns the decoded
        bits and, per subframe, TB ok, DCI ok, CFI ok."""
        def mark(name):
            if stages is not None:
                torch.cuda.synchronize()
                stages.append((name, time.perf_counter()))

        mark("start")
        rx = s
        if snr_db is not None:
            sigma = torch.sqrt(torch.mean(torch.abs(s) ** 2) / (10.0 ** (snr_db / 10.0)) / 2.0)
            n = torch.randn((2,) + s.shape, generator=gen, device=s.device) * sigma
            rx = s + torch.complex(n[0], n[1])
        mark("awgn")
        grid, ce, info = self.ue.fft_estimate(rx, SF_IDX)
        mark("fft_estimate")
        cfi_dec, _ = self.pcfich.decode(grid, ce)
        mark("pcfich")
        # all subframes' candidates share one Viterbi kernel launch
        ok, cand = self.pd._decode_mixed_traced(grid, ce, self.groups, self.dci_len, self.mask)
        match = torch.all(cand == self.dci_bits_t, dim=-1)
        dci_ok = torch.any(ok & match, dim=-1)
        mark("pdcch_search")
        bits, tb_ok = self.pdsch.decode(grid, ce, info["noise"])
        mark("pdsch_decode")
        return bits, tb_ok, dci_ok, cfi_dec == CFI


def reset_counts():
    from srslte_tpu_torch.ops import tdec_cuda, viterbi_cuda

    tdec_cuda.siso_windowed.launches = 0
    viterbi_cuda.viterbi_decode.launches = 0


def read_counts():
    from srslte_tpu_torch.ops import tdec_cuda, viterbi_cuda

    return {"siso_windowed": tdec_cuda.siso_windowed.launches,
            "viterbi_decode": viterbi_cuda.viterbi_decode.launches}


def counted_dispatch(chain, s, snr_db, gen):
    """One dispatch with the launch counts set to 0 just before and read just after."""
    reset_counts()
    out = chain.decode(s, snr_db, gen)
    torch.cuda.synchronize()
    counts = read_counts()
    for name, n in counts.items():
        check(n > 0, f"the main path did not launch the {name} kernel")
    return out, counts


def phase_clean(chain, bits, s):
    (dec, tb_ok, dci_ok, cfi_ok), counts = counted_dispatch(chain, s, None, None)
    check(dec.shape == bits.shape and dec.dtype == torch.uint8, "decoded TB shape or type")
    check(bool(cfi_ok.all()), f"clean channel: CFI decoded in {int(cfi_ok.sum())}/{BATCH}")
    check(bool(dci_ok.all()), f"clean channel: DCI found in {int(dci_ok.sum())}/{BATCH}")
    check(bool(tb_ok.all()), f"clean channel: TB CRC ok in {int(tb_ok.sum())}/{BATCH}")
    check(bool((dec == bits).all()), "clean channel: decoded bits differ from the bits sent")
    print(f"[4 main path, clean] {BATCH} subframes: every CFI = {CFI}, DCI found with the "
          f"transmitted payload, every TB passes CRC and equals the bits sent; launches {counts}",
          flush=True)


def phase_noisy(chain, bits, s):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    (dec, tb_ok, dci_ok, cfi_ok), counts = counted_dispatch(chain, s, SNR_DB, gen)
    n_ok = int(tb_ok.sum())
    check(int(cfi_ok.sum()) == BATCH, f"PCFICH decode failed: {int(cfi_ok.sum())}/{BATCH}")
    check(int(dci_ok.sum()) == BATCH, f"PDCCH blind search failed: {int(dci_ok.sum())}/{BATCH}")
    check(n_ok >= 0.8 * BATCH, f"BLER implausibly high: {n_ok}/{BATCH}")
    check(bool((dec[tb_ok] == bits[tb_ok]).all()), "a TB that passed CRC differs from the bits sent")
    print(f"[5 main path, {SNR_DB} dB] first dispatch: CFI {BATCH}/{BATCH}, DCI {BATCH}/{BATCH}, "
          f"TB ok {n_ok}/{BATCH}; kernel launches in this dispatch {counts}", flush=True)

    times, tb_total = [], n_ok
    for _ in range(N_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, tb_ok, dci_ok, cfi_ok = chain.decode(s, SNR_DB, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(dci_ok.all()) and bool(cfi_ok.all()), "CFI or DCI lost in a timed dispatch")
        tb_total += int(tb_ok.sum())
    bler = 1.0 - tb_total / (BATCH * (N_TIMED + 1))
    ms = float(np.median(times))
    msps = BATCH * chain.cell.ofdm.sf_len / (ms * 1e-3) / 1e6
    stages = []
    chain.decode(s, SNR_DB, gen, stages=stages)
    split = ", ".join(f"{name} {(t - stages[i][1]) * 1e3:.2f}"
                      for i, (name, t) in enumerate(stages[1:]))
    print(f"[5 main path, {SNR_DB} dB] {N_TIMED} timed dispatches of {BATCH} subframes: "
          f"{[round(t, 3) for t in times]} ms (first three: mean "
          f"{float(np.mean(times[:3])):.3f}), median {ms:.3f} ms/dispatch = {msps:.2f} Msamples/s "
          f"({msps / REALTIME_MSPS:.2f} x real time at 100 PRB); TB BLER over "
          f"{BATCH * (N_TIMED + 1)} TBs {bler:.4f}")
    print(f"[5 main path, {SNR_DB} dB] one more dispatch with a synchronise after each stage, "
          f"ms: {split}", flush=True)
    return counts, ms


def phase_profile(chain, s, dispatch_ms):
    """One 16 dB dispatch under torch.profiler: the device's kernel time by
    name, and its share of an unprofiled dispatch (`dispatch_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain.decode(s, SNR_DB, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel events only: an operator's row repeats the time of its kernels
    rows = sorted(((k.self_device_time_total, k.count, k.key) for k in prof.key_averages()
                   if k.device_type == DeviceType.CUDA and k.self_device_time_total > 0),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    check(busy_us > 0, "the profiler saw no device time")
    print(f"[profile] one dispatch under the profiler ({wall_us / 1e3:.2f} ms on the host clock "
          f"with its overhead): {sum(r[1] for r in rows)} kernels and copies, device busy "
          f"{busy_us / 1e3:.2f} ms = {100 * busy_us / (dispatch_ms * 1e3):.1f} % of an unprofiled "
          f"dispatch ({dispatch_ms:.3f} ms), idle share {100 - 100 * busy_us / (dispatch_ms * 1e3):.1f} %")
    for us, count, key in rows[:14]:
        print(f"[profile]   {us / 1e3:8.3f} ms  {count:5d} x  {key[:90]}")
    sys.stdout.flush()


def main():
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    chain = Chain()
    t0 = time.perf_counter()
    bits, s = chain.encode(seed=31)
    torch.cuda.synchronize()
    check(s.shape == (BATCH, 30720) and bool(torch.isfinite(torch.view_as_real(s)).all()),
          "stimulus shape or values")
    print(f"[4 main path] stimulus: {BATCH} subframes encoded on the card in "
          f"{time.perf_counter() - t0:.1f} s (tables built and uploaded on first use)", flush=True)
    phase_clean(chain, bits, s)
    counts, dispatch_ms = phase_noisy(chain, bits, s)
    if "--profile" in sys.argv[1:]:
        phase_profile(chain, s, dispatch_ms)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
