#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Builds the hand-written CUDA kernels from `srslte_tpu_torch/csrc/` (the
windowed turbo SISO in float32 and in 16 bits, and the Viterbi decoder),
holds each against its plain PyTorch version on the card (both SISOs by
value, the Viterbi bit for bit) at the shape each path gives it and times it
against its bound, then drives the port's paths through the entry points a
user would call, each at its deployment's full width, in batches of 128
subframes, with the peak device memory of one dispatch per path:

- the 20 MHz UE downlink receive chain at the srsUE cc_worker scope:
  eNB encode (stimulus) -> AWGN -> UeDl.fft_estimate -> Pcfich.decode ->
  Pdcch blind search (18 candidates) -> Pdsch.decode (turbo cascade);
  100 PRB, 1 port, normal CP, CFI 2, subframe 4, DCI 1A at Location(8, 8)
  for RNTI 0x46, PDSCH over all 100 PRB at mcs 27 (64QAM), clean and at
  16 dB time-domain SNR (float32 SISO; one 16 dB dispatch in 16 bits);
- the 20 MHz eNB PUSCH receive chain with UCI (srsENB's per-UE PUSCH
  decode): UeUl.encode_pusch (stimulus) -> AWGN -> EnbUl.decode_pusch
  (SC-FDMA, channel estimate, MMSE, DFT de-precoding, UCI demux with the
  long CQI through the Viterbi kernel, UL-SCH turbo cascade); 100 PRB,
  PUSCH on PRBs 2-97 at mcs 28 (64QAM), subframe 2, RNTI 0x46, 1-bit ACK and
  a 30-bit CQI, clean and at 18 dB, with the SISO in float32 and in 16 bits;
- the device Gold sequence against the host one;
- the turbo BLER gates of tests/test_bler_gates.py on the card, in float32
  (checks) and in 16 bits (printed), and its LDPC gate (BG1 Zc 64 at 2 dB,
  no block error in 50);
- DL HARQ on the 20 MHz deployment above: each TB sent at rv 0, then only the
  TBs still failing again at rv 2, 3, 1 (DlGrant.full(100, 27, rv)), AWGN ->
  UeDl.fft_estimate -> Pdsch.soft_bits -> mac.harq.combine_llr into each
  TB's soft buffer -> mac.harq.decode_state;
- the eNB's UL control at 100 PRB: PUCCH (six format 1a ACKs at
  N1 + ncce, an empty 1a resource, a positive SR on format 1, a format 2b
  with a wideband CQI and 2 ACK bits, a format 3 with 10 ACK bits) from the
  port's UeUl through EnbUl.decode_pucch; SRS over 96 PRB (Srs.estimate);
  PRACH format 0 detection (prach_detect) with delays, and on noise alone;
- the blind receiver from a capture at 20 MHz (the example pair
  srslte_tpu_torch.examples.pdsch_enodeb -> file -> pdsch_ue): four frames of
  cell 301 (1 port, CFI 2, DCI 1A over all 100 PRB at mcs 27 for RNTI
  0x1234) encoded on the card, written and read back through FileSink /
  FileSource, then `receive` (cell search -> UeSync.find -> track_block in
  blocks of 5 -> UeMib at subframe 0 -> per subframe fft_estimate, PCFICH,
  PDCCH search, PDSCH) on the clean stream and on one with a delay, a CFO
  and AWGN; timed whole and by stage, with its host synchronisations
  counted;
- (phase 13, the main path of the latest slice) the 2x2 spatial-
  multiplexing DL at 20 MHz: Cell(100 PRB, id 1, 2 ports), CFI 2, subframe
  4, RNTI 0x46; the eNB puts CRS, PCFICH, a random ACK / NACK / off PHICH
  pattern, DCI 2 (TM4, precoding information 2) or 2A (TM3) at the first
  L=8 UE-specific location and both TBs (mcs 27 over all 100 PRB) through
  PdschSm.encode2; a fixed 2x2 channel and AWGN; the UE runs
  UeDl.fft_estimate on both rx antennas, PCFICH, the blind search and PHICH
  on rx 0, rebuilds the grants and the pmi from the DCI it read back, and
  PdschSm.decode2 on both antennas; clean and at SM_SNR_DB, timed, staged,
  with its host synchronisations counted;
- (phase 14) the 4-port cell: PdschSm4 with pmi 0 and with CDD over a 4x4
  channel, the 4-port control channels, and the 4-port PBCH;
- (phase 15) the rest of the DL at 100 PRB: the "interpolate" and "wiener"
  estimates on phase 13's stimulus, PMCH on an extended-CP cell, the DwPTS
  PDSCH of a TDD special subframe and the extended-duration PHICH;
- (phase 16, the main path of the latest slice) the channel emulator:
  phase 5's deployment, its own TB in each of 128 subframes, laid end to end
  as one stream through FadingChannel (EPA 5 Hz at mcs 20, EVA 70 Hz at mcs
  13, ETU 300 Hz at mcs 6 with "interpolate"), cut back into subframes,
  AWGN, Chain.receive; clean and at the SNR the JAX package needs, the
  channel and the decode timed; a delay and RLF bursts on EPA5;
- (phase 17) the rails: phase 12's capture with and without the high-speed
  train, a delay, FileRadio, PipeRadio over the UDP pipe at the ZMQ base
  rate (one subframe per burst), -30 dB, the AGC and the blind receiver;
  IntraMeasure ranking three PCIs; resample_arb on a tone;
- (phase 18, the main path of the latest slice) the full stack: EnbApp and
  UeApp over the air, TTI by TTI, on a 20 MHz FDD cell (100 PRB, cell 42,
  1 port): MIB, SIB1, SIB2, PRACH -> RAR -> msg3 -> msg4, RRC, NAS attach
  with Milenage AKA, AS security, DRB, ciphered user plane and HARQ-ACK;
  scenario A attaches and moves 64 packets of 1400 bytes each way, B two
  UEs, C a forced NACK and its retransmission, D release, paging and
  reconnect; every state at the TTI the JAX package reaches it
  (tests/rehearse_stack.py), every packet once and in order to its own UE;
  ms per call of the four per-TTI entry points, host synchronisations per
  TTI, memory, the device-table cache and kernel launches by shape;
- (phase 19, the main path of the latest slice) the full stack over the S1
  wire: phase 18's cell and first subscriber, EnbApp(s1=...) speaking S1AP
  (SCTP, or framed TCP where the kernel has none) to the port's EpcApp,
  whose MME drives the S/P-GW over GTP-C on S11, user data as GTP-U G-PDUs
  on S1-U to SGi; S1-A attaches and moves 64 packets of 1400 bytes each way
  between the UE and SGi, S1-R releases the UE over S1 and sends one packet
  from it; the S1AP procedures and every state at the JAX package's
  (tests/rehearse_s1.py), every packet once and in order, the release on
  both ends; ms per call of the five per-TTI calls (epc.step among them),
  S1AP and GTP-U PDUs per direction, host synchronisations per TTI, memory,
  the table cache after S1-A and S1-R and kernel launches by shape;
- (phase 20, the main path of the latest slice) the NR PHY at 52 PRB
  (NrCarrier(52, mu 0): 10 MHz at 15 kHz SCS, cell 1, slot 4, RNTI 0x4601),
  128 slots per dispatch, encoded on the card: 20a DCI 1_0 (K 63, E 432,
  N 512) on Coreset.full(48) at aggregation 4 and its PDSCH at mcs 27 of the
  qam64 table over PRB 0-51 (5 BG1 code blocks of Zc 384 per slot); the UE
  searches the DCI in 16 slots (and under a wrong RNTI) and decodes the
  PDSCH of all 128 slots with the grant it read back, clean and at
  NR_SNR_DB (noise drawn on the host; the lost slots held against the JAX
  package's on the same grid); ms per dispatch and per search, stage ms,
  launches per ldpc_decode and per polar_decode_list (torch.profiler), host
  synchronisations, peak memory; 20b 256QAM (mcs 27 of the qam256 table),
  20c two layers over 2 rx (the 2x2 MMSE), 20d the PUSCH on a DCI 0_0
  grant, PUCCH formats 0-4, UCI (block code, polar with PC bits) and a
  CSI-RS measurement packed into a CSI report on format 2.  Neither CUDA
  kernel runs on this path: LDPC and polar are plain PyTorch.
- (phase 21) the NR stack at 52 PRB (NrCarrier(52, n_id 33),
  Coreset.full(48, 1, id 1), the workers over all 52 PRB at mcs 20): 21a
  GnbNrWorker / UeNrWorker with 8 TBs at 10.5 dB, the UE's blind DCI search,
  PDSCH demodulation, HARQ soft combining (rv 0, 2, 3, 1) and a PUCCH format
  1 ACK / NACK that the gNB decodes, slot by slot; 21b 16 packets ciphered
  by NEA2 through GnbNrStack / UeNrStack (PDCP-NR, RLC UM-NR, the MAC-NR
  PDU) at 16 dB; 21c the FAPI-like PNF / VNF split over loopback UDP; the
  per-slot ACK / NACK, the delivery slots and the retransmissions equal to
  the JAX package's on the same host-drawn noise, every packet once and in
  order; ms per slot of each per-slot call (the DCI search apart), host
  synchronisations per slot, the VNF's round trip, the memory of 16 soft
  buffers.  Neither CUDA kernel runs on this path either;
- (phase 22, the Viterbi's main path of the latest slice) the NB-IoT
  downlink at 1.92 Msps (cell 257, RNTI 0x2345): 22a the example pair
  (srslte_tpu_torch.examples.npdsch_enodeb's 8 frames, impaired by a delay,
  a CFO and AWGN on the host, then npdsch_ue.receive: NPSS / NSSS cell
  search, CFO correction, MIB-NB on NPBCH, the NPDCCH blind search, NPDSCH);
  22b the longest grant, TBS 680 over 10 subframes (the Viterbi's [1, 704]
  launch), 32 TBs on 2 NRS ports (Alamouti) and on 1, clean and at the SNR
  the JAX package needs; counts at least the JAX package's on the same
  samples, ms and Viterbi launches per stage;
- (phase 23, the main path of both kernels in the latest slice) sidelink
  TM1/2 at 50 PRB (normal CP, N_SL_ID 168, the flat channel of
  tests/test_sidelink.py with AWGN drawn on the host per RE): 23a the sync
  subframe of four ids (PSSS, coherent SSSS, the PSBCH's MIB-SL through a
  [1, 56] Viterbi); 23b 128 subframes received one by one as the reference's
  control/data flow test does (the SCI-0 from the PSCCH through a [1, 59]
  Viterbi, then the PSSCH it describes: 48 PRB at mcs 20, 4 code blocks of K
  5184), clean and at SL_SNR_DB, and 16 grids of noise alone on the PSCCH;
  23c 128 subframes of one subframe index through one Pssch.decode (the SISO
  at B 512), timed; every id, MIB and SCI right, every TB clean, the lost
  TBs at SL_SNR_DB among the JAX package's on the same grids;
- (phase 24) the scale-out modules on 8 virtual shards of the one card
  (a mesh over [cuda:0] * 8): 24a ShardedDlPipeline on phase 5's deployment,
  8 carriers x 16 subframes, against the unsharded e2e; 24b
  TimeShardedDlChain at 100 PRB, 128 subframes through a 3-tap channel,
  rx against rx_sharded over 2 and 8 shards (bits, flags and the channel
  estimate equal; the halo carries state); 24c sharded_pss_search over a 20
  MHz stream of 128 subframes against pss_find_peak; ms sharded and
  unsharded (no scaling is claimed: the shards share one card);
- (phase 25) the JAX package's remaining entry points, ported: 25a
  examples.cell_search.scan on phase 12's capture (cell 301 and phase 12's
  MIB); 25b examples.run_epc, run_enb and run_ue as three processes, the
  eNB and the UE on the card: attach and the SGi echo, each process held
  to 300 s;
- (phase 26) one CUDA graph per call: every entry point the JAX package
  jits, on its path at the path's width, each call of every draw one
  replay equal to its eager run (`__wrapped__`), its kernel launches by
  shape the eager run's and its arguments unchanged; phase 5's DL on two
  16 dB draws, a clean one and one at HARQ_SNR_DB (the cascade's
  full-batch branch); ms per call graphed and eager; then the graph cache
  lowered to one graph on the PMCH path (every other graph evicted) and the
  path replayed after it;
- (phase 27) the DL-SCH cascade's branches:
  one graphed `dlsch_decode` captured on the mix of tests/test_torch_fec.py
  whose 64 TBs all pass phase 1, replayed on all six mixes (K 512 code
  blocks, the pool measured with the card's SISO kernel), each replay the
  eager run's bits, CRC flags and launches by shape; nested conds on a toy
  function held against eager.

Exits non-zero on any failure, and when there is no CUDA device.  The line
before the last is the card's name and power limit; the last line is
`{"ok": true, "device": {...}}`.

`python3 chip_smoke.py --profile` adds one DL and one UL dispatch, one HARQ
round, one UL-control dispatch, one blind receive, one 2x2 and one 4x4 SM
dispatch, one EVA70 channel + decode dispatch, the rails' blind receive and
the full stack's bulk windows (scenario A, and S1-A over the wire) and one
NR DL dispatch under `torch.profiler` and prints
the device's busy share and the kernels that take most of its time.  The line before the kernels line
gives each phase's wall time and the total.
"""

import collections
import contextlib
import functools
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

REALTIME_MSPS = 30.72  # 100 PRB real-time sample rate
SNR_DB = 16.0
CFI = 2
RNTI = 0x46
SF_IDX = 4
UL_SNR_DB = 18.0  # upper shoulder of the mcs 28 TB waterfall
UL_SF_IDX = 2
BATCH = 128
N_TIMED = 10  # the host clock of a shared machine has outliers: report the median
BF16 = torch.bfloat16
F32 = torch.float32

# Peaks of one H100 SXM: the bound of a kernel is the larger of its bytes
# over the memory rate (NVIDIA data sheet) and its operations over the rate of
# their type.  The kernels do adds, max and compares outside the tensor cores:
# one such operation per lane per clock, 132 SMs x 128 lanes x 1.98 GHz, in
# float32 or unpacked bfloat16 (the data sheet's 67 TFLOP/s float32 counts a
# fused multiply-add as two); two per lane per clock in packed bf16x2
# instructions, which the 16-bit SISO uses.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 33.5e12
PACKED_BF16_OPS_PER_S = 67e12

# The shape each path gives each kernel at its first, full-batch launch (the
# turbo cascade's later phases run on the code blocks that still fail).
SISO_SHAPES = {"dl": (BATCH * 11, 5824, 256, 32),  # 11 code blocks of K 5824 per subframe
               "sf": (11, 5824, 256, 32),  # the blind receiver decodes one subframe at a time
               "ul": (BATCH * 12, 5952, 256, 32),  # 12 code blocks of K 5952 per subframe
               "pmch": (BATCH * 7, 5632, 256, 32),  # PMCH mcs 20: 7 code blocks of K 5632
               "dwpts": (BATCH * 8, 5888, 256, 32),  # DwPTS mcs 27, 75 PRB of TBS: 8 of K 5888
               # phase 16, the 1-port DL at the fading profiles' mcs: 20 (EPA5;
               # PMCH's shape), 13 (EVA70), 6 (ETU300)
               "epa": (BATCH * 7, 5632, 256, 32), "eva": (BATCH * 4, 5760, 256, 32),
               "etu": (BATCH * 2, 5184, 256, 32),
               # phase 18, the full stack: one subframe's code blocks at a
               # time; K < 256 as one window (L = K, T = 0): the first launch,
               # SIB1's K 144; the RAR's K 80 and 112 (56 or 88 bits), SIB2's
               # 248; then scenario A's largest DL and UL code blocks
               "stack": (1, 144, 144, 0), "stack_rar80": (1, 80, 80, 0),
               "stack_rar112": (1, 112, 112, 0), "stack_sib2": (1, 248, 248, 0),
               "stack_dl_max": (13, 5824, 256, 32), "stack_ul_max": (3, 5696, 256, 32),
               # phase 19, the full stack over the S1 wire: the other code
               # block sizes its TBs give (phase 19 checks that every (K, L,
               # T) it launches is held here)
               "s1_k280": (1, 280, 128, 32), "s1_k704": (1, 704, 128, 32),
               "s1_k3008": (1, 3008, 256, 32), "s1_k4800": (2, 4800, 256, 32),
               # phase 23, the sidelink: one subframe's PSSCH (4 code blocks of
               # K 5184, 16QAM mcs 20 over 48 PRB), then 23c's batch of 128
               # subframes; phase 24, one shard's 16 subframes of phase 5's
               # deployment (11 x K 5824 each) on the carrier and the time axis
               "sl_sf": (4, 5184, 256, 32), "sl_batch": (BATCH * 4, 5184, 256, 32),
               "scale": (16 * 11, 5824, 256, 32),
               # phase 27: the cascade's mixes, 64 TBs of one K 512 block
               "cascade": (64, 512, 128, 32)}
VIT_SHAPES = {"pbch": (8, 40),  # PBCH: 4 frame phases x 2 port hypotheses, MIB + CRC16
              "dl": (BATCH * 18, 44),  # 18 PDCCH candidates, DCI 1A + CRC16
              "ul": (BATCH, 38),  # one long CQI per subframe: 30 bits + CRC8, tail-biting
              "dci2": (BATCH * 18, 67),  # DCI 2 at 2 ports (51 bits) + CRC16
              "dci2a": (BATCH * 18, 64),  # DCI 2A at 2 ports (48 bits) + CRC16
              "dci2_4p": (BATCH * 20, 70),  # DCI 2 at 4 ports (54 bits), 20 candidates of 39 CCEs
              "pbch4": (12, 40),  # 4-port PBCH: 4 frame phases x 3 port hypotheses
              # phase 18 at 100 PRB, CFI 2: the common search (all 18 aligned
              # L 4 and 8 candidates) for DCI 1A/0 (28 bits) and 1C (15 bits),
              # the C-RNTI search (UE-specific + common, up to 22) for 1A/0 and
              # for format 1 (39 bits, 16 UE-specific)
              "stack_common": (18, 44), "stack_1c": (18, 31), "stack_crnti": (22, 44),
              "stack_f1": (16, 55),
              # phase 22, NB-IoT: NPBCH's 16 hypotheses (8 block phases x 2 port
              # patterns) of MIB-NB + CRC16, one NPDCCH candidate (DCI N0/N1 +
              # CRC16), 22a's NPDSCH (TBS 144 + CRC24) and 22b's (TBS 680 + 24)
              "nb_npbch": (16, 50), "nb_npdcch": (1, 39), "nb_npdsch": (1, 168),
              "nb_npdsch_max": (1, 704),
              # phase 23, the sidelink: the PSBCH (MIB-SL of 40 bits + CRC16) and
              # the PSCCH at 50 PRB (SCI-0 of 43 bits + CRC16), one grid each
              "sl_psbch": (1, 56), "sl_pscch": (1, 59)}
# The paths of the `kernels` line and the shape keys of their first SISO and
# Viterbi launches; each kernel's top-level numbers are those of its main
# path (MAIN_PATH).  The DL HARQ path's first launch is the DL shape (every
# code block of rv 0); the blind receiver's (and the rails') first Viterbi
# launch is the MIB decode of subframe 0, its first SISO launch that
# subframe's PDSCH; an SM path's first SISO launch is codeword 0 (decode2
# decodes each codeword as its own batch, as the C library does), and each
# codeword of the 2x2 and the 4x4 cell has the DL's 11 code blocks of K
# 5824.  PMCH and DwPTS run no PDCCH; the faded paths run the DL's.
PATHS = {"dl_f32": ("dl", "dl"), "dl_bf16": ("dl", "dl"), "ul_f32": ("ul", "ul"),
         "ul_bf16": ("ul", "ul"), "dl_harq": ("dl", "dl"), "blind": ("sf", "pbch"),
         "sm2_tm4": ("dl", "dci2"), "sm2_tm3": ("dl", "dci2a"), "sm4": ("dl", "dci2_4p"),
         "pmch": ("pmch", None), "dwpts": ("dwpts", None),
         "channel_epa5": ("epa", "dl"), "channel_eva70": ("eva", "dl"),
         "channel_etu300": ("etu", "dl"), "rails": ("sf", "pbch"), "stack": ("stack", "pbch"),
         "s1": ("stack", "pbch"), "nbiot": (None, "nb_npbch"), "sidelink": ("sl_sf", "sl_psbch"),
         "scale_carrier": ("scale", None), "scale_time": ("scale", None),
         "cascade": ("cascade", None)}
KERNEL_PATHS = {"siso_windowed": ("dl_f32", "ul_f32", "dl_harq", "blind", "sm2_tm4", "sm2_tm3",
                                  "sm4", "pmch", "dwpts", "channel_epa5", "channel_eva70",
                                  "channel_etu300", "rails", "stack", "s1", "sidelink",
                                  "scale_carrier", "scale_time", "cascade"),
                "siso_windowed_bf16": ("dl_bf16", "ul_bf16", "channel_eva70"),
                "viterbi_decode": ("dl_f32", "dl_bf16", "ul_f32", "ul_bf16", "blind", "sm2_tm4",
                                   "sm2_tm3", "sm4", "channel_epa5", "channel_eva70",
                                   "channel_etu300", "rails", "stack", "s1", "nbiot",
                                   "sidelink")}
# the main path of the latest slice that runs each kernel: phase 27 (the
# DL-SCH cascade's six mixes replayed from one graph, first launch B 64 K
# 512) for the float32 SISO; phase 23 (the sidelink, whose first Viterbi
# launch is 23a's PSBCH [1, 56]) for the Viterbi; the scale-out paths (phase
# 24a's sharded step, 24b's 8-shard receive) launch the SISO at one shard's
# B 176 K 5824 and no Viterbi; the 16-bit SISO's phase 16 (EVA70, a second
# dispatch on the same noise draw)
MAIN_PATH = {"siso_windowed": "cascade", "siso_windowed_bf16": "channel_eva70",
             "viterbi_decode": "sidelink"}

# The spatial-multiplexing DL (phases 13-15, `SmChain`): both TBs at mcs 27
# over all 25 RBGs; DCI 2 at 2 ports carries precoding information 2, TM4
# codebook entry pinfo - 1 = 1 (tests/test_dci_formats.py:266-300)
SM_MCS = (27, 27)
SM_PINFO = 2
SM_H2 = ((1.0, 0.3 + 0.2j), (0.25 - 0.3j, 0.9))  # tests/test_dci_formats.py:303
SM4_H_SEED = 2  # 4x4: complex Gaussian / sqrt(2) + 2 I, tests/test_mimo4.py:41
SM_SEED = 43
# The lowest whole dB at which the JAX package's PdschSm.decode2 (PdschSm4
# for the 4x4) decodes >= 95 % of the TBs of 16 subframes of this stimulus
# on the CPU (`python tests/rehearse_sm.py`): TM4 21 (at 20 dB codeword 1
# decodes 0/16), TM3 19, 4x4 pmi 0 17, 4x4 CDD 16; each phase runs at the
# highest of its deployments'.  With the "interpolate" estimate the JAX
# package decodes codeword 1 of the TM4 stimulus in 0/16 subframes at 21 dB
# and needs 24: phase 15 runs it at both.
SM_SNR_DB = 21.0
SM4_SNR_DB = 17.0
SM_INTERP_SNR_DB = 24.0


# DL HARQ (phase 10): the DL deployment above at an SNR where rv 0 alone
# decodes about half of the TBs (63 of 128 on an H100), so that the
# retransmissions have work to do
HARQ_SNR_DB = 14.7
HARQ_SEED = 41
# the round-2 (rv 2) batch of SISO code blocks that HARQ_SNR_DB and HARQ_SEED
# give: 11 code blocks for each of the 65 TBs still failing after rv 0;
# phase 3 holds the kernel at this shape, phase 10 again at the round's own
# if it differs
HARQ_RAGGED = (11 * 65, 5824, 256, 32)

# the turbo BLER gates of tests/test_bler_gates.py: (K, Eb/N0 dB, trials,
# seed, block errors required: "none" or "some")
GATES = ((6144, 1.5, 100, 6144, "none"), (504, 2.0, 100, 504, "none"),
         (1024, -2.0, 20, 1, "some"))

# eNB UL control (phase 11): 100 PRB, cell id 1, FDD, normal CP, subframe 2
N1_PUCCH_AN = 12  # Sib2.n1_pucch_an: format 1a ACK at N1 + ncce
ACK_NCCE = (0, 4, 8, 12, 16, 20)  # six UEs' first CCE
DTX_NCCE = 24  # a seventh ACK resource on which nothing is sent
ACK_DET_THRESH = 0.25  # a 1a metric below this reads as DTX at the eNB
N_RB_2 = 1  # PRB pairs of the format 2 region
N_PUCCH_2 = 5  # format 2b: m = 0
N_PUCCH_3 = 15  # format 3: m = 3
PUCCH_SNR_DB = 3.0  # per occupied RE, one UE's RE at unit power
SRS_SNR_DB = 10.0
PRACH_SNR_DB = -10.0  # per sample, the preamble at unit power
PRACH_MAX_DELAY = 1080  # samples, inside the N_cs window (38 lags = 1113)

# Blind receive from a capture (phase 12): the JAX package's example pair
# (examples/pdsch_enodeb.py -> capture file -> examples/pdsch_ue.py) at
# 20 MHz: cell 301, 1 port, FDD, normal CP, CFI 2, DCI 1A over all 100 PRB
# at mcs 27 for RNTI 0x1234, frames SFN 0-3
BLIND_PRB = 100
BLIND_CELL_ID = 301
BLIND_RNTI = 0x1234
BLIND_MCS = 27
BLIND_BUCKET = (63776, 11, 5824)  # TBS, code blocks, K: the DL deployment's load
BLIND_FRAMES = 4
BLIND_SEED = 9  # the frames' bits (the same in every frame)
BLIND_MAX_SF = 10 * BLIND_FRAMES  # more than the stream holds after the first lock
# stream B: the impairments of tests/test_e2e_file.py at 20 MHz
BLIND_DELAY = 1234  # samples of silence before the capture
BLIND_CFO = 0.18  # subcarrier spacings
BLIND_SNR_DB = 25.0  # AWGN this far below the stream's mean power per sample
BLIND_NOISE_SEED = 1
BLIND_TB_OK = 0.8  # share of stream B's TBs that must pass their CRC
# TBs of stream A that the JAX package's receiver decodes (of 35), on the CPU,
# on the same stream made by the port's eNB: `python tests/rehearse_blind_receive.py`.
# It loses the first block of 5 subframes: its PSS-based CFO estimate is off
# by about 0.002 subcarrier on this stream (the PDSCH shares the PSS
# symbol), too much for mcs 27 until the CP estimate has halved it once.
# Stream A's gate is that count, since a receiver that matches it cannot
# decode every TB.
BLIND_JAX_TB_OK_A = 30

# The channel emulator (phase 16, the main path of the latest slice): phase
# 5's deployment (its own TB in each of 128 subframes) laid end to end as one
# stream of 3,932,160 samples, so that the fading is continuous across
# subframes, through FadingChannel at 30.72 Msps for the three 36.101 Annex
# B.2.2 propagation conditions that srsRAN's [channel.dl] emulator offers,
# cut back into [128, 30720], AWGN, and `Chain.receive`
CHANNEL_SRATE = 30_720_000
CHANNEL_SEED = 61  # the TBs
FADING_SEED = 7  # the Jakes parameters (the same channel in both packages)
# name: (profile, Doppler Hz, mcs, channel estimate, SNR dB).  The SNR is the
# lowest whole dB at which the JAX package decodes >= 95 % of the first 32
# TBs through the same channel (`python tests/rehearse_channel.py`, CPU):
# EPA5 16 (15: 10/32), EVA70 13 (12: 30/32).  ETU300 takes "interpolate" (5;
# 4: 28/32): the JAX package's "average" decodes 116 and its "wiener" 119 of
# the 128 clean faded TBs, and neither reaches 95 % at 30 dB; phase 16
# reports both on the ETU300 stream.
CHANNELS = {"epa5": ("epa", 5.0, 20, "average", 16.0),
            "eva70": ("eva", 70.0, 13, "average", 13.0),
            "etu300": ("etu", 300.0, 6, "interpolate", 5.0)}
ETU_REPORTED = ("average", "wiener")
# (CFI, DCI, TB) of the 128 clean faded subframes that the JAX package
# decodes (tests/rehearse_channel.py): the clean gate of each profile
CHANNEL_JAX_CLEAN = {"epa5": (128, 128, 128), "eva70": (128, 128, 128),
                     "etu300": (128, 128, 128)}
# radio-link failure on the EPA5 stream: srsRAN's [channel.dl.rlf] on/off
# shape scaled to a 128 ms stream, after a delay well inside the CP
RLF_ON_MS, RLF_OFF_MS = 10.0, 2.0
CHANNEL_DELAY = 3.5  # samples

# The rails (phase 17): phase 12's stream A through the 36.101 B.3 scenario 3
# high-speed train (f_d 750 Hz, ds 300 m, d_min 2 m, 300 km/h: the train
# passes the mast at t = 1.8 s, 20 ms into a stream that starts at HST_T0)
# and a delay, then a file radio, the UDP pipe radio at the ZMQ base rate (one
# subframe per burst), -30 dB and the AGC, the blind receiver; and the same
# rails without the train
HST = dict(f_d=750.0, ds=300.0, d_min=2.0, v=300.0)
HST_T0 = 1.78
HST_DELAY = 5.5  # samples
ZMQ_BASE_SRATE = 23_040_000
PIPE_PORT = 43700  # the pipe radio's UDP port (a retry takes the next one)
PIPE_TRIES = 4  # a burst that does not arrive whole is sent again, at most 3 times
AGC_SCALE_DB = -30.0
AGC_TARGET = 0.3
# (subframes with the DCI, TBs) of 35 that the JAX receiver decodes on the
# same streams (the delay, the resample_fft round trip per subframe, -30 dB,
# the AGC; with and without the train first; tests/rehearse_channel.py
# --rails): without the train stream A's 30; with it the DCI is lost in 8
# subframes after the sign flip and every TB at mcs 27: the receiver's CFO
# loop (half the residual per block of 5 subframes) trails a Doppler that
# sweeps 960 Hz in 40 ms
RAILS_JAX = {"rails": (35, 30), "rails_hst": (27, 0)}
# resample_arb on a tone of ARB_TONE cycles per sample: at the ZMQ base rate
# from the cell rate, and at the rate of tests/test_channel_io.py's tone test
# (EVM < 0.02 there).  At the rational 0.75 the plan cycles through three
# phase rows of the filter bank, and the JAX package's EVM is ARB_JAX_EVM on
# this tone (tests/rehearse_channel.py --rails): the gate there is the
# reference's own
ARB_RATE, ARB_TEST_RATE, ARB_TONE, ARB_GUARD = 23.04 / 30.72, 0.876543, 0.02, 32
ARB_JAX_EVM = 0.059153

# The full stack (phase 18, the main path of the latest slice): EnbApp and
# UeApp over the air, TTI by TTI, on one 20 MHz FDD cell (Cell(100 PRB, id
# 42, 1 port), normal CP) with the apps' own conventions (CFI 2, the default
# SIB2, mcs 5 for broadcast, the CQI-driven DCI 1 scheduler), the
# subscribers of tests/test_e2e_stack.py and tests/test_multi_ue.py and a
# clean channel, as the reference's full-stack tests run it:
# A: attach, then STACK_BULK packets of STACK_BULK_BYTES each way (seeded
#    bytes), queued at once; B: tests/test_multi_ue.py's two UEs (the second
#    from STACK_UE2_START); C: tests/test_harq_feedback.py's forced CRC
#    failure of the first DL data TB; D: tests/test_e2e_stack.py's release,
#    page and reconnect.
STACK_PRB = 100
STACK_CELL_ID = 42
STACK_OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
STACK_SUBSCRIBERS = (("001010123456789", bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")),
                     ("001010000000001", bytes.fromhex("fec86ba6eb707ed08905757b1bb44b8f")))
STACK_BULK = 64
STACK_BULK_BYTES = 1400
STACK_SEED = 18
STACK_UE2_START = 80
STACK_MAX_TTI = {"A": 600, "B": 500, "C": 300, "D": 400}
# The TTI at which the JAX package's apps first reach each state of each
# scenario, on the CPU (`python tests/rehearse_stack.py`, the same
# `stack_scenario`); it delivers every packet of each, in order.  Phase 18
# holds the port to each TTI.
STACK_JAX = {
    "A": {"mib": 0, "sib1": 5, "sib2": 15, "rach_sent": 20, "ra_done": 27, "rrc_connected": 33,
          "drb": 55, "nas_attached": 65, "dl_first": 66, "rrc_reconfigured": 73, "dl_all": 76,
          "ul_first": 78, "ul_all": 120},
    "B": {"mib_1": 0, "sib1_1": 5, "sib2_1": 15, "rach_sent_1": 20, "ra_done_1": 27,
          "rrc_connected_1": 33, "drb_1": 55, "nas_attached_1": 65, "dl_first_1": 66,
          "dl_all_1": 66, "rrc_reconfigured_1": 73, "ul_first_1": 73, "ul_all_1": 73, "mib_2": 80,
          "sib1_2": 85, "sib2_2": 95, "rach_sent_2": 100, "ra_done_2": 107,
          "rrc_connected_2": 113, "drb_2": 135, "nas_attached_2": 145, "dl_first_2": 146,
          "dl_all_2": 146, "rrc_reconfigured_2": 153, "ul_first_2": 153, "ul_all_2": 153},
    "C": {"mib": 0, "sib1": 5, "sib2": 15, "rach_sent": 20, "ra_done": 27, "rrc_connected": 33,
          "drb": 55, "nas_attached": 65, "nack": 66, "dl_first": 70, "dl_all": 70, "retx": 70},
    "D": {"mib": 0, "sib1": 5, "sib2": 15, "rach_sent": 20, "ra_done": 27, "rrc_connected": 33,
          "drb": 55, "nas_attached": 65, "release_sent": 65, "camped": 66, "paged": 69,
          "reconnected": 77}}

# Phase 19 (`s1_scenario`): phase 18's cell, conventions and first
# subscriber with the core behind the wire protocols of srsRAN's srsENB <->
# srsEPC deployment (tests/test_s1_wire.py: s1ap.cc:33, mme_gtpc.cc,
# spgw/gtpu.cc:105): EnbApp(s1=...) speaks S1AP over SCTP (framed TCP where
# the kernel has no SCTP) to the MME of the EpcApp in the same process, the
# MME drives the S/P-GW over GTP-C on S11, user data crosses S1-U as GTP-U
# G-PDUs, SGi is `sgi_tx` and `spgw.send_dl`.  S1-A: the attach, then
# STACK_BULK packets of STACK_BULK_BYTES each way; S1-R: the eNB's
# UEContextReleaseRequest (EnbS1.release_request), then one UL packet from
# the released UE.
S1_MAX_TTI = 600
S1_RECONNECT_TTIS = 100  # TTIs the released UE's packet may take to reach SGi
S1_RECONNECT_PACKET = b"s1-reconnect"
S1_S11_TIMEOUT = 2.0  # seconds the MME waits for the S/P-GW on S11

# The JAX package's apps through its own EpcApp on the same scenario, on
# the CPU (`python tests/rehearse_s1.py`, two runs that agree on every
# value): the first TTI of each state and the S1AP procedures in the order
# they crossed the association.
# It delivers every packet of the bulk, in order; the released UE's packet
# never reaches SGi (no "reconnect_ul"): its eNB drops the context on the
# S1 release without an RRC release, so the UE stays connected to nothing.
S1_JAX = {
    "first": {"mib": 0, "s1_setup": 1, "sib1": 5, "sib2": 15, "rach_sent": 20, "ra_done": 27,
              "rrc_connected": 33, "ics": 54, "drb": 55, "nas_attached": 65,
              "bearer_modified": 65, "dl_first": 67, "rrc_reconfigured": 73, "dl_all": 76,
              "ul_first": 78, "ul_all": 120, "release_requested": 120, "enb_released": 122,
              "mme_released": 122, "session_deleted": 122, "reconnect_sent": 122},
    "procedures": ("ul:s1_setup_request", "dl:s1_setup_response", "ul:initial_ue_message",
                   "dl:downlink_nas_transport", "ul:uplink_nas_transport",
                   "dl:downlink_nas_transport", "ul:uplink_nas_transport",
                   "dl:initial_context_setup_request", "ul:initial_context_setup_response",
                   "ul:uplink_nas_transport", "ul:ue_context_release_request",
                   "dl:ue_context_release_command", "ul:ue_context_release_complete")}

# (TBS, G, code blocks) of the 1-port DL deployment at each mcs that a phase
# runs (phases 4-5: 27; phase 16: 20, 13, 6)
# NR PHY (phase 20): the JAX package's default carrier NrCarrier(n_prb=52,
# mu=0), 10 MHz at 15 kHz SCS, cell id 1 (srsRAN 21.04's NR NSA cell); slot 4
# of every dispatch, as the LTE cells use subframe 4
NR_PRB = 52
NR_RNTI = 0x4601
NR_WRONG_RNTI = 0x3333
NR_SLOT = 4
NR_SS = (0, 0, 2, 2, 0)  # the worker's UE-specific search space (L 4 and 8)
NR_MCS = 27
NR_SEARCHED = 16  # slots of a dispatch whose DCI the UE searches
NR_SEED = 51
NR_H = 0.9 * np.exp(0.5j)  # a flat gain (tests/test_nr_slot_loop.py's)
NR_H2 = ((1.0 + 0.1j, 0.35 - 0.2j), (-0.3 + 0.25j, 0.9 - 0.15j))  # tests/test_nr_mimo2.py's
# per path: the lowest whole dB (Es/N0 per RE of the unit-power symbols sent)
# at which the JAX package decodes >= 95 % of 32 TBs of the path's stimulus
# (python tests/rehearse_nr.py, on the CPU)
NR_SNR_DB = {"dl": 22.0, "dl256": 29.0, "mimo2": 14.0, "ul": 23.0}
# per path: the slots of the noise-free 128-slot stimulus whose TB the JAX
# package does not decode (python tests/rehearse_nr.py --clean): every LLR
# saturates at +-1e3, and where all edges of a check row have that one
# magnitude the reference's min-sum masks them all, sends +-inf and the
# codeword turns to NaN (ROADMAP.md queue C item 19); the port fails the same
NR_JAX_CLEAN = {"dl": (), "dl256": (25, 90, 120), "mimo2": (), "ul": ()}
# per path: the slots of the noisy dispatch (the 128-slot stimulus with the
# noise NrChain.noisy draws from the path's seed at NR_SNR_DB) whose TB the
# JAX package does not decode (python tests/rehearse_nr.py --noisy); the
# 32-TB draw that set NR_SNR_DB decodes whole, this wider one does not
NR_JAX_NOISY = {"dl": (14, 17, 18, 22, 31, 47, 49, 50, 53, 83, 84, 91, 95, 97, 111, 112, 121, 127),
                "dl256": (3, 11, 20, 42, 53, 55, 68, 96, 111), "mimo2": (4, 10, 44, 105),
                "ul": ()}
# the noisy dispatch's lost slots may differ from NR_JAX_NOISY in this many:
# float32 rounding (the batch's reductions, the 2x2 MMSE) moves a TB that sits
# on the waterfall's edge; on the CPU the port itself loses (4, 10, 105) of
# "mimo2" decoding the 128 slots at once and (4, 10, 44, 105) in fours of 32
NR_NOISY_SLACK = 3
# tests/test_bler_gates.py's LDPC gate: BG1 Zc 64 at Eb/N0 2 dB, 0 block
# errors in 50, seed 3, 12 iterations
LDPC_GATE = (1, 64, 2.0, 50, 3, 12)

DL_BUCKETS = {27: (63776, 82800, 11), 20: (39232, 82800, 7), 13: (22920, 55200, 4),
              6: (10296, 27600, 2)}

# NR stack (phase 21, `nr_stack_scenario`): tests/test_nr_worker.py's
# carrier NrCarrier(52, n_id 33) and Coreset.full(48, 1, id 1), the workers
# over the whole carrier (PRB 0-51) at mcs 20 of the qam64 table (TBS 25104:
# 3 BG1 code blocks of Zc 384), slots alternating 0 / 1 (`slot % 2`).
# "harq": NRS_HARQ_TBS TBs at NRS_HARQ_SNR_DB (tests/test_nr_worker.py:93-95;
# rv 0 alone fails at this width) with AWGN on the DL and on the PUCCH;
# "stack": NRS_PACKETS ciphered packets (NEA2, NRS_KEY) through GnbNrStack /
# UeNrStack at NRS_STACK_SNR_DB (tests/test_nr_stack.py; the UL clean, as
# there), the sixth packet 2.5 TBs long; "vnf": NRS_VNF_SLOTS slots through GnbPnf / GnbVnf / UePnf / UeVnf
# over loopback UDP (tests/test_vnf.py), noiseless.  AWGN is drawn on the
# host from the scenario's seed (so tests/rehearse_nr_stack.py gives the JAX
# package the same noise).
NRS_PRB = 52
NRS_CELL_ID = 33
NRS_MCS = 20
NRS_TBS = 25104
NRS_HARQ_TBS = 8
NRS_HARQ_SNR_DB = 10.5
NRS_STACK_SNR_DB = 16.0
NRS_PACKETS = 16
NRS_VNF_SLOTS = 4
NRS_MAX_SLOTS = {"harq": 48, "stack": 48}
NRS_SEEDS = {"harq": 77, "stack": 3, "vnf": 4}
NRS_KEY = bytes(range(16))
# what the JAX package does on the same scenarios (python
# tests/rehearse_nr_stack.py, on the CPU): per slot (HARQ pid, rv, the ACK
# the gNB decodes), the slots at which a TB is delivered, and retransmissions;
# for "vnf" the TBs delivered byte-equal and the ACKs that cleared their
# process.  In "harq" every rv 0 transmission's LDPC blocks fail to converge
# in the JAX package (slots 0, 2, ..., 14) and every rv 2 combine converges.
_HARQ_SLOTS = tuple(x for _ in range(NRS_HARQ_TBS) for x in ((0, 0, "N"), (0, 2, "A")))
NR_STACK_JAX = {
    "harq": {"timeline": _HARQ_SLOTS, "delivered_at": tuple(range(1, 16, 2)), "n_retx": 8},
    "stack": {"timeline": ((0, 0, "A"),) * 18, "delivered_at": tuple(range(18)), "n_retx": 0},
    "vnf": {"delivered": 4, "acked": 4, "slots": 4}}

# NB-IoT (phase 22): the reference example's cell (n_id 257) and RNTI 0x2345.
# 22a: the example pair, examples/npdsch_enodeb.py's defaults (8 frames,
# DCI N1 in frame 1 subframe 1, NPDSCH I_TBS 5 / I_SF 1: TBS 144 in
# subframes 3-4), impaired as tests/test_nbiot_ue.py:_impair does;
# 22b: the longest grant (I_TBS 4, I_SF 7: TBS 680 over 10 subframes, the
# Viterbi's [1, 704] launch), NB_TBS TBs clean and at NB_SNR_DB, each on its
# own 10 subframes of two frames (skipping subframes 0, 5 and 9 of even
# frames), 2 NRS ports (Alamouti) through Npdsch(nof_ports=2).decode and 1
# port through UeDlNbiot.decode_npdsch, which the reference builds for 1 port
NB_ID = 257
NB_RNTI = 0x2345
NB_FRAMES = 8
NB_IMPAIR = (1234, 120.0, 12.0, 1)  # delay (samples), CFO (Hz), SNR (dB), noise seed
NB_LONG = (4, 7)  # I_TBS, I_SF
NB_TBS = 32
NB_SEED = 81
# per port count: the lowest whole dB (below the mean power of the nonzero
# samples) at which the JAX package decodes >= 95 % of the NB_TBS TBs
# (python tests/rehearse_nbiot.py, on the CPU)
NB_SNR_DB = {2: -9.0, 1: -10.0}
# what the JAX package does on the same samples (the same script): 22a's
# counts (cell, MIB, DCIs, TBs equal to the bits sent); per port count, the
# indices of 22b's TBs it loses, clean and at NB_SNR_DB
NB_JAX = {"example": (1, 1, 1, 1), "long2": ((), ()), "long1": ((), (21,))}

# Sidelink TM1/2, normal CP (phase 23, the main path of both kernels in the
# latest slice): a 10 MHz carrier (50 PRB, the widest bandwidth the JAX
# package's sidelink tests use, tests/test_sidelink.py:99, :178) and the
# JAX test's flat channel SL_H (:19-22) with AWGN drawn on the host per RE.
# 23a: a sync subframe (PSSS, SSSS, the PSBCH in the centre 6 PRB) per id of
# SL_SYNC_IDS, at the test's noise; 23b: SL_N subframes (sf_idx = i mod 10),
# each the SCI-0 on the PSCCH (PRB 0, cyclic shift 3) and its PSSCH over
# PRBs 2-49 at mcs 20 for N_X_ID = SL_ID, received as
# test_sidelink_control_data_flow receives it (:132-157): SCI, then the
# PSSCH the SCI describes; SL_NOISE_ONLY grids of noise alone through the
# PSCCH decoder; 23c: SL_N subframes of one sf_idx through one Pssch.decode
SL_PRB = 50
SL_ID = 168  # N_SL_ID, and the PSSCH's N_X_ID (the SCI's group_dst_id)
SL_SYNC_IDS = (0, 167, 168, 335)
SL_MIB = dict(bandwidth=3, direct_frame=517, direct_subframe=9, in_coverage=1)  # sl-Bandwidth n50
SL_PSCCH = (0, 3)  # PRB, DMRS cyclic shift
SL_ALLOC = (2, 48)  # first PRB, PRBs: the SCI's RIV
SL_MCS = 20
SL_BUCKET = (20616, 27648, 4, 5184)  # TBS, G, code blocks, K (16QAM; E 6912)
SL_H = 0.9 * np.exp(0.6j)
SL_SYNC_NOISE = 0.02  # per component, as the test's _chan
SL_N = 128
SL_NOISE_ONLY = 16
SL_BATCH_SF_IDX = 5
SL_SEEDS = {"sf": 71, "batch": 72}  # the TBs; their AWGN from the seed + 1000
# the lowest whole dB (per RE, over the received data power |SL_H|^2) at
# which the JAX package decodes >= 95 % of the first 32 TBs of 23b's
# stimulus, and the TBs it loses there of 23b's and 23c's SL_N
# (`python tests/rehearse_sidelink.py`, on the CPU, the same host-drawn grids)
SL_SNR_DB = 13.0
SL_JAX = {"sf": (), "batch": ()}

# Scale-out on virtual shards of the one card (phase 24): 24a phase 5's
# deployment (Cell(100, id 1), DlGrant.full(100, 27), subframe 4, RNTI
# 0x46) through ShardedDlPipeline on SCALE_SHARDS carriers of SCALE_SF
# subframes each, mesh {"carrier": 8}; 24b TimeShardedDlChain on Cell(100,
# id 3) and DlGrant.full(100, 27) (subframe 4's geometry, CFI 1), SL_N
# subframes through tests/test_time_shard.py's 3-tap channel and noise
# (:20-28), drawn on the host, over 2 and 8 shards; 24c sharded_pss_search
# over a 20 MHz stream of SL_N subframes, one PSS inside a shard and one 60
# samples before a shard boundary (tests/test_parallel.py:43-63)
SCALE_SHARDS = 8
SCALE_SF = 16
SCALE_SEED = 91
SCALE_TAPS = (1.0, 0.45 * np.exp(0.8j), 0.25 * np.exp(-1.9j))
SCALE_NOISE = 0.02  # per component
SCALE_PSS = ((5555 * 16, 1), (3 * (BATCH * 30720 // 8) - 60, 2))  # (sample, N_id_2)
# TBs of 24b's SL_N that the JAX package's TimeShardedDlChain.rx decodes
# on the same samples (`python tests/rehearse_scale_out.py`, on the CPU)
SCALE_JAX_TIME_OK = 128
# the three-process topology (phase 25b): the UDP sample pipe's DL and UL
# ports, and each process's hard limit
SCRIPT_PORTS = (43811, 43810)
SCRIPT_LIMIT_S = 300.0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


HEAD_START_CYCLES = 2_000_000  # about 1 ms of the card's clock


def event_ms(fn, n, warm=False):
    """Mean device time of fn() over n calls, by CUDA events.  The card is
    first kept busy for about 1 ms, so that the host has queued the calls
    before the start event runs: a kernel shorter than its wrapper's host
    time is timed on the device, not at the rate the host issues it.
    `warm`: fn just ran on these inputs, so no warm-up call."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if not warm:
        fn()  # warm-up (first-call set-up)
    torch.cuda.synchronize()
    torch.cuda._sleep(HEAD_START_CYCLES)
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


def kernel_label(ptxas_line):
    """A readable name for the kernel instance of a ptxas 'Compiling entry
    function' line: siso_kernel<float|bf16x2, emit_ext, perm> or the name."""
    m = re.search(r"(siso_kernel)I(f|14__nv_bfloat162)Lb([01])ELb([01])E", ptxas_line)
    if m:
        kind = "float" if m.group(2) == "f" else "bf16x2"
        return f"{m.group(1)}<{kind}, emit_ext={m.group(3)}, perm={m.group(4)}>"
    m = re.search(r"\d([a-z][a-z_]*_kernel)", ptxas_line)
    return m.group(1) if m else ptxas_line.strip()


def phase_build():
    from srslte_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(force=True)
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        fn = name
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = kernel_label(line)
            elif "registers" in line or "spill" in line:
                print(f"[2 build] {fn}: {line.strip().removeprefix('ptxas info    : ')}")
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


def bf16_siso_state(rng, B, K):
    """A 16-bit decoder state on the card from realistic LLRs (as
    `turbo_siso_inputs`), scaled and clipped by `tdec.turbo_start`."""
    from srslte_tpu_torch.phy.fec import tdec, turbo

    bits = rng.integers(0, 2, (B, K)).astype(np.uint8)
    coded = turbo.turbo_encode(bits, K).to(torch.float32)
    sigma = 10 ** (-1.5 / 20)
    noise = torch.as_tensor(rng.standard_normal(coded.shape, dtype=np.float32), device=coded.device)
    llr = -((1 - 2 * coded) + sigma * noise) * (2 / sigma**2)
    return tdec.turbo_start(llr, K, siso_dtype=BF16)


def bound(nbytes, nops, ops_per_s=SCALAR_OPS_PER_S):
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return max(by, op), "bytes" if by >= op else "operations", by, op


def time_siso(name, sys_, par, b0, pi, L, T):
    """CUDA-event times of one SISO launch as the turbo step makes it
    (extrinsic out, without and with the interleave), its plain version's,
    its bound and its launch geometry."""
    from srslte_tpu_torch.ops import tdec_cuda

    B, K = sys_.shape
    bf16 = sys_.dtype == BF16
    plan = tdec_cuda.siso_plan(B, K, L, T, bf16)
    per_sm = tdec_cuda.blocks_per_sm(plan, emit_ext=True, perm=True)
    ms_nat = event_ms(lambda: tdec_cuda.siso_windowed(sys_, par, b0, L, T, emit_ext=True), 10)
    ms_perm = event_ms(lambda: tdec_cuda.siso_windowed(sys_, par, b0, L, T, emit_ext=True,
                                                       perm=pi), 10)
    # the plain version ran on these inputs in check_siso (or the 16-bit check)
    plain_ms = event_ms(lambda: tdec_cuda.siso_windowed_plain(sys_, par, b0, L, T,
                                                              emit_ext=True, perm=pi), 1,
                        warm=True)
    W, e = -(-K // L), sys_.element_size()
    # bytes: sys, par, out [B, K] and beta_init [B, 8] in the metric type,
    # perm [K] int32, each once; operations: per window T+L alpha steps (1
    # add for gamma, 16 adds, 8 max), T+L beta steps (16 adds, 8 max), L LLRs
    # (16 adds, 14 max, 2 subtractions); in 16 bits also the re-pinning of
    # both metric vectors, 8 subtractions each per step, in bf16x2 pairs
    repin = 16 if bf16 else 0
    b_ms, b_by, by, op = bound(3 * B * K * e + B * 8 * e + K * 4,
                               B * W * ((T + L) * (25 + 24 + repin) + L * 32),
                               PACKED_BF16_OPS_PER_S if bf16 else SCALAR_OPS_PER_S)
    shape = f"B={B} K={K} L={L} T={T}"
    ms = (ms_nat + ms_perm) / 2
    per_sm_windows = per_sm * tdec_cuda.GROUPS_PER_BLOCK * plan.windows_per_group
    # time per merged step: the kernel runs in waves of resident blocks
    waves = plan.blocks / (per_sm * torch.cuda.get_device_properties(0).multi_processor_count)
    step_ns = ms_nat * 1e6 / math.ceil(waves) / (T + L)
    print(f"[3 kernels] {name} {shape} emit_ext: {ms_nat:.4f} ms without perm, {ms_perm:.4f} ms "
          f"with perm, plain version {plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by} "
          f"({by:.4f} ms bytes, {op:.4f} ms operations), {100 * b_ms / ms:.1f} % of the bound; "
          f"{plan.blocks} blocks of {plan.threads} threads, {plan.smem_bytes} shared bytes per "
          f"block, {per_sm} blocks = {per_sm_windows} windows per SM, {waves:.2f} waves, "
          f"{step_ns:.1f} ns per merged step without perm", flush=True)
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms, "smem_bytes": plan.smem_bytes,
            "windows_per_sm": per_sm_windows}


def time_viterbi(llr, length):
    """CUDA-event times of one tail-biting Viterbi launch, its plain
    version's, its bound and its launch geometry."""
    from srslte_tpu_torch.ops import viterbi_cuda

    nc = llr.shape[0]
    ms = event_ms(lambda: viterbi_cuda.viterbi_decode(llr, length, True), 20)
    plain_ms = event_ms(lambda: viterbi_cuda.viterbi_decode_plain(llr, length, True), 1)
    # bytes: llr [B, 3 len] float32 in, bits [B, len] uint8 out; operations
    # per candidate and step (3 len steps, tail-biting by 3x repeat): 10 for
    # the 8 branch metrics, 64 x (2 adds, 1 max, 1 compare); traceback 3
    # integer operations per step
    b_ms, b_by, by, op = bound(nc * 3 * length * 4 + nc * length,
                               nc * 3 * length * (10 + 64 * 4 + 3))
    plan = viterbi_cuda.viterbi_plan(nc, length, True)
    per_sm = viterbi_cuda.blocks_per_sm(plan) * plan.candidates_per_block
    shape = f"B={nc} len={length} tail-biting"
    print(f"[3 kernels] viterbi_decode {shape}: {ms:.4f} ms, plain version {plain_ms:.1f} ms, "
          f"bound {b_ms:.6f} ms by {b_by} ({by:.6f} ms bytes, {op:.6f} ms operations), "
          f"{100 * b_ms / ms:.2f} % of the bound; {plan.blocks} blocks of {plan.threads} threads, "
          f"{plan.smem_bytes} shared bytes per block, {per_sm} candidates per SM resident, "
          f"{nc / torch.cuda.get_device_properties(0).multi_processor_count:.2f} per SM "
          f"launched", flush=True)
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms, "smem_bytes": plan.smem_bytes,
            "candidates_per_sm": per_sm}


def viterbi_chain_ns(length):
    """ns per trellis step of one tail-biting candidate alone (B = 1): the
    latency of the kernel's step chain, launch and traceback included."""
    from srslte_tpu_torch.ops import viterbi_cuda

    llr = torch.randn((1, 3 * length), device="cuda")
    ms = event_ms(lambda: viterbi_cuda.viterbi_decode(llr, length, True), 20)
    ns = ms * 1e6 / (3 * length)
    print(f"[3 kernels] viterbi_decode B=1 len={length} tail-biting: {ms:.4f} ms, "
          f"{ns:.1f} ns per trellis step ({3 * length} steps)", flush=True)
    return ns


def ext_perm_variants(pi):
    """The four (emit_ext, perm) variants of a SISO launch."""
    return ((False, None), (True, None), (False, pi), (True, pi))


def check_siso(rng, B, K, L, T):
    """The float32 SISO against its plain version by value (max abs
    difference 0; -0.0 and 0.0 count as equal) in all four emit_ext / perm
    variants, on realistic inputs; returns (largest difference, the inputs
    (sys, par, beta_init, perm))."""
    from srslte_tpu_torch.ops import tdec_cuda
    from srslte_tpu_torch.phy.fec import turbo

    sys_, par, b0 = turbo_siso_inputs(rng, B, K)
    pi = torch.as_tensor(turbo.qpp_perm(K).astype(np.int32), device="cuda")
    worst = 0.0
    for emit_ext, perm in ext_perm_variants(pi):
        got = tdec_cuda.siso_windowed(sys_, par, b0, L, T, emit_ext=emit_ext, perm=perm)
        ref = tdec_cuda.siso_windowed_plain(sys_, par, b0, L, T, emit_ext=emit_ext, perm=perm)
        torch.cuda.synchronize()
        check(got.dtype == F32 and bool(torch.isfinite(got).all()),
              f"SISO K={K}: type or non-finite output")
        err = float((got - ref).abs().max())
        check(err == 0.0, f"SISO B={B} K={K} L={L} T={T} ext={emit_ext} "
                          f"perm={perm is not None}: max abs diff {err}")
        worst = max(worst, err)
        print(f"[3 kernels] siso_windowed B={B} K={K} L={L} T={T} emit_ext={emit_ext} "
              f"perm={perm is not None}: max abs diff {err} (max |llr| "
              f"{float(ref.abs().max()):.4g})")
    return worst, (sys_, par, b0, pi)


def check_short_siso(rng, B, K):
    """Code blocks of K < 256 as the decoder runs them on the card
    (`tdec._siso_full`: the SISO kernel as one window, L = K, T = 0)
    against the full-length scan `tdec._siso` that the CPU runs, both on
    the card: LLRs within 1e-4 of their scale (float32 without and with
    renormalisation), signs equal; then 3-iteration turbo decodes on the
    card and on the CPU: hard bits equal, and equal to the bits sent.
    Returns the largest LLR difference over the scale."""
    from srslte_tpu_torch.phy.fec import tdec, turbo

    bits = rng.integers(0, 2, (B, K)).astype(np.uint8)
    coded = turbo.turbo_encode(bits, K).to(F32)
    sigma = 10 ** (-3.0 / 20)
    noise = torch.as_tensor(rng.standard_normal(coded.shape, dtype=np.float32), device=coded.device)
    llr = -((1 - 2 * coded) + sigma * noise) * (2 / sigma**2)
    sys_, par1, _, (tx, tz), _ = tdec._split_dcat(llr, K)
    n0 = read_counts()["siso_windowed"]
    got = tdec._siso_full(sys_, par1, tx, tz)
    check(read_counts()["siso_windowed"] == n0 + 1,
          f"K={K}: the one-window pass did not launch the kernel")
    ref = tdec._siso(sys_, par1, tx, tz)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max()) / scale
    big = ref.abs() > 1e-4 * scale
    check(err <= 1e-4 and bool(((got > 0) == (ref > 0))[big].all()),
          f"one-window SISO B={B} K={K}: {err:.3g} of the scale from the full scan")
    hard = tdec.turbo_decode(llr, K, n_iter=3)[0].cpu()
    hard_cpu = tdec.turbo_decode(llr.cpu(), K, n_iter=3)[0]
    check(bool((hard == hard_cpu).all()) and bool((hard.numpy() == bits).all()),
          f"turbo decode K={K}: card and CPU hard bits differ, or differ from the bits sent")
    print(f"[3 kernels] siso_windowed B={B} K={K} L={K} T=0 (one window) against tdec._siso on "
          f"the card: max abs diff {err:.3g} of the scale {scale:.4g}, signs equal; 3-iteration "
          f"turbo_decode hard bits equal to the CPU's and to the bits sent")
    return err


def phase_kernels():
    """Each kernel against its plain version on the card, at small and edge
    shapes and at the shape each path gives it; returns per kernel its largest
    difference and, per shape key of SISO_SHAPES / VIT_SHAPES, its times and
    bound."""
    from srslte_tpu_torch.ops import tdec_cuda, viterbi_cuda
    from srslte_tpu_torch.phy.fec import convolutional, turbo

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    path_shapes = {}  # shape -> the path keys that give it (EPA5 and PMCH share one)
    for k, v in SISO_SHAPES.items():
        path_shapes.setdefault(v, []).append(k)

    # Both SISOs are held to their plain versions by value (max abs
    # difference 0; -0.0 and 0.0 count as equal) in all four emit_ext / perm
    # variants, at small shapes, at the edges (a single window, K = L, where
    # window 0 is also the last; B x W odd, so the 16-bit pairing has a dummy
    # half; K not a multiple of L and B not of 32) and at each path's shape.
    edges = ((3, 256, 256, 32), (7, 1152, 128, 32), (77, 1008, 128, 32))

    # --- SISO ------------------------------------------------------------
    # the float32 SISO also at the HARQ path's round-2 shape (the code blocks
    # of the TBs still failing after rv 0)
    siso_err, siso_t = 0.0, {}
    for (B, K, L, T) in dict.fromkeys(((64, 40, 8, 4), (64, 1024, 128, 32), *edges,
                                       HARQ_RAGGED, *SISO_SHAPES.values())):
        err, (sys_, par, b0, pi) = check_siso(rng, B, K, L, T)
        siso_err = max(siso_err, err)
        keys = path_shapes.get((B, K, L, T), [])
        if keys:
            t = time_siso("siso_windowed", sys_, par, b0, pi, L, T)
            siso_t.update(dict.fromkeys(keys, t))
        del sys_, par, b0

    # the full stack's code blocks of K < 256: the kernel as one window
    # against the CPU's full-length scan, on the card, and whole decodes
    short_err = max(check_short_siso(rng, 64, k) for k in (40, 80, 112, 144, 248))

    # --- SISO, 16 bits ----------------------------------------------------
    bf_err, bf_t = 0.0, {}
    for (B, K, L, T) in (*edges, SISO_SHAPES["dl"], SISO_SHAPES["ul"], SISO_SHAPES["eva"]):
        st = bf16_siso_state(rng, B, K)
        pi = torch.as_tensor(turbo.qpp_perm(K).astype(np.int32), device=dev)
        for emit_ext, perm in ext_perm_variants(pi):
            got = tdec_cuda.siso_windowed(st.sys_sat, st.par1, st.b01, L, T,
                                          emit_ext=emit_ext, perm=perm)
            ref = tdec_cuda.siso_windowed_plain(st.sys_sat, st.par1, st.b01, L, T,
                                                emit_ext=emit_ext, perm=perm)
            torch.cuda.synchronize()
            check(got.dtype == BF16 and bool(torch.isfinite(got.float()).all()),
                  f"16-bit SISO K={K}: type or non-finite output")
            err = float((got.float() - ref.float()).abs().max())
            check(err == 0.0, f"16-bit SISO B={B} K={K} L={L} T={T} ext={emit_ext} "
                              f"perm={perm is not None}: max abs diff {err}")
            bf_err = max(bf_err, err)
            print(f"[3 kernels] siso_windowed bf16 B={B} K={K} L={L} T={T} emit_ext={emit_ext} "
                  f"perm={perm is not None}: max abs diff {err} (max |llr| "
                  f"{float(ref.float().abs().max()):.4g})")
        keys = path_shapes.get((B, K, L, T), [])
        if keys:
            t = time_siso("siso_windowed_bf16", st.sys_sat, st.par1, st.b01, pi, L, T)
            bf_t.update(dict.fromkeys(keys, t))
        del st

    # --- Viterbi ---------------------------------------------------------
    # The DL's two DCI lengths with and without tail-biting, the UL's long
    # CQI, the blind receiver's PBCH, the SM paths' DCI 2 / 2A lengths and
    # the 4-port PBCH as the paths run them (tail-biting); then the edges: one
    # candidate, a ragged B, the one-bit code, one block exactly full of
    # candidates (PBCH's 40 bits), NB-IoT NPDSCH's longest (704 bits) and the
    # longest the kernel takes (its shared memory per block nearly full).
    # Codes shorter than the encoder's 6-bit memory get random LLRs.
    vit_err, vit_t = 0, {}
    vit_path = {v: k for k, v in VIT_SHAPES.items()}
    both = (True, False)
    for nc, length, tb_settings in ((BATCH * 18, 44, both), (BATCH * 18, 27, both),
                                    (*VIT_SHAPES["ul"], (True,)), (*VIT_SHAPES["pbch"], (True,)),
                                    (*VIT_SHAPES["dci2"], (True,)), (*VIT_SHAPES["dci2a"], (True,)),
                                    (*VIT_SHAPES["dci2_4p"], (True,)),
                                    (*VIT_SHAPES["pbch4"], (True,)),
                                    *((*VIT_SHAPES[k], (True,)) for k in
                                      ("stack_common", "stack_1c", "stack_crnti", "stack_f1",
                                       "nb_npbch", "nb_npdcch", "nb_npdsch", "nb_npdsch_max",
                                       "sl_psbch", "sl_pscch")),
                                    (1, 44, both), (77, 44, both),
                                    (3, 1, both), (viterbi_cuda.CANDIDATES_PER_BLOCK, 40, (True,)),
                                    (4, 704, both), (2, viterbi_cuda.max_length(True), (True,)),
                                    (2, viterbi_cuda.max_length(False), (False,))):
        bits = rng.integers(0, 2, (nc, length)).astype(np.uint8)
        # encoded on the host: the card keeps no generator matrix of these lengths
        coded = (torch.as_tensor(convolutional.conv_encode_np(bits), dtype=torch.float32,
                                 device=dev) if length >= 6 else None)
        for tail_biting in tb_settings:
            # clean, noisy, and clean with the last 8 steps erased (LLR 0): there
            # every end state ties, which is what tells the first maximum from
            # another, and every decision of those steps is a tie
            for kind, sigma in (("clean", 0.0), ("noisy", 0.8), ("erased tail", 0.0)):
                noise = torch.as_tensor(rng.standard_normal((nc, 3 * length), dtype=np.float32),
                                        device=dev)
                if coded is None:
                    kind = "random" if kind != "erased tail" else kind
                    llr = noise.contiguous()
                else:
                    llr = (-(1 - 2 * coded) + sigma * noise).contiguous()
                if kind == "erased tail":
                    llr[:, -24:] = 0.0
                got = viterbi_cuda.viterbi_decode(llr, length, tail_biting)
                ref = viterbi_cuda.viterbi_decode_plain(llr, length, tail_biting)
                torch.cuda.synchronize()
                nbad = int((got != ref).sum())
                check(nbad == 0, f"Viterbi B={nc} len={length} tail_biting={tail_biting} {kind}: "
                                 f"{nbad} bits differ from the plain version")
                if tail_biting and kind in ("clean", "noisy"):
                    ber = float((got.cpu().numpy() != bits).mean())
                    check(ber < (1e-9 if kind == "clean" else 1e-2),
                          f"Viterbi B={nc} len={length} {kind}: BER {ber}")
                vit_err = max(vit_err, nbad)
                print(f"[3 kernels] viterbi_decode B={nc} len={length} tail_biting={tail_biting} "
                      f"{kind}: bits equal to the plain version")
                key = vit_path.get((nc, length))
                if key is not None and tail_biting and kind == "noisy":
                    vit_t[key] = time_viterbi(llr, length)
    chain_ns = {f"len{n}": viterbi_chain_ns(n) for n in (44, 704)}

    common = {"route": "cuda", "source": "srslte_tpu_torch/csrc/tdec_siso.cu",
              "replaces": "srslte_tpu/ops/tdec_pallas.py:98", "library_ms": None}
    return {"siso_windowed": {**common, "max_abs_err": siso_err, "_times": siso_t,
                              "one_window_vs_scan_rel_err": short_err},
            "siso_windowed_bf16": {**common, "max_abs_err": bf_err, "_times": bf_t},
            "viterbi_decode": {**common, "source": "srslte_tpu_torch/csrc/viterbi.cu",
                               "replaces": "srslte_tpu/ops/viterbi_pallas.py:58",
                               "max_abs_err": float(vit_err), "b1_ns_per_step": chain_ns,
                               "_times": vit_t}}


class Chain:
    """The deployment's objects and the two sides of the main path: phase 5's
    deployment at mcs 27, or (phase 16) at another mcs or with another
    channel estimate; `device="cpu"` lets tests/rehearse_channel.py build
    the same stimulus on the host."""

    def __init__(self, mcs=27, chest="average", device="cuda"):
        from srslte_tpu_torch.phy.common.params import Cell
        from srslte_tpu_torch.phy.enb.enb_dl import EnbDl
        from srslte_tpu_torch.phy.phch.dci import Dci1A, format0_1a_size, pack_format1a
        from srslte_tpu_torch.phy.phch.pcfich import Pcfich
        from srslte_tpu_torch.phy.phch.pdcch import (Location, Pdcch, common_locations,
                                                     rnti_mask, ue_locations)
        from srslte_tpu_torch.phy.phch.pdsch import Pdsch
        from srslte_tpu_torch.phy.ue.ue_dl import UeDl

        self.device = device
        self.cell = Cell(n_prb=100, id=1, nof_ports=1)
        self.dci = Dci1A(rb_start=0, l_crb=100, mcs=mcs)
        self.grant = self.dci.grant(100)
        self.pdsch = Pdsch(self.cell, self.grant, SF_IDX, cfi=CFI, rnti=RNTI)
        self.enb = EnbDl(self.cell)
        self.ue = UeDl(self.cell, chest_algorithm=chest)
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
        self.mask = torch.as_tensor(rnti_mask(RNTI), device=device)
        self.dci_bits_t = torch.as_tensor(self.dci_bits, device=device)
        cfg = self.pdsch.cfg
        check((cfg.tbs, cfg.G, cfg.seg.C) == DL_BUCKETS[mcs],
              f"unexpected DL-SCH bucket at mcs {mcs}")
        check(self.cell.ofdm.sf_len == 30720, "unexpected subframe length")

    def encode(self, seed):
        """BATCH subframes of stimulus: (bits [B, tbs] on the device, samples [B, sf_len])."""
        rng = np.random.default_rng(seed)
        bits = torch.as_tensor(rng.integers(0, 2, (BATCH, self.grant.tbs), dtype=np.uint8),
                               device=self.device)
        g = self.enb.put_base(self.enb.empty_grids((BATCH,), device=self.device), SF_IDX)
        g = self.enb.put_pcfich(g, SF_IDX, CFI)
        g = self.enb.put_pdcch(g, SF_IDX, CFI, self.dci_bits, RNTI, self.tx_loc)
        g = self.enb.put_pdsch(g, self.pdsch, bits)
        return bits, self.enb.gen_signal(g)[..., 0, :]

    def receive(self, rx, stages=None, siso_dtype=F32):
        """The UE side on a batch of received subframes: a dict of the
        decoded bits and, per subframe, TB ok, DCI ok, CFI ok and the false
        CRC hits (candidates that pass their CRC with another payload)."""
        def mark(name):
            if stages is not None:
                torch.cuda.synchronize()
                stages.append((name, time.perf_counter()))

        grid, ce, info = self.ue.fft_estimate(rx, SF_IDX)
        mark("fft_estimate")
        cfi_dec, _ = self.pcfich.decode(grid, ce)
        mark("pcfich")
        # all subframes' candidates share one Viterbi kernel launch
        ok, cand = self.pd._decode_mixed_traced(grid, ce, self.groups, self.dci_len, self.mask)
        match = torch.all(cand == self.dci_bits_t, dim=-1)
        mark("pdcch_search")
        bits, tb_ok = self.pdsch.decode(grid, ce, info["noise"], siso_dtype=siso_dtype)
        mark("pdsch_decode")
        return {"bits": bits, "tb_ok": tb_ok, "dci_ok": torch.any(ok & match, dim=-1),
                "cfi_ok": cfi_dec == CFI, "false_hits": (ok & ~match).sum(dim=-1)}

    def decode(self, s, snr_db, gen, stages=None, siso_dtype=F32):
        """One dispatch of the receive chain on BATCH subframes; noise is
        drawn anew from `gen` (none for snr_db None).  Returns the decoded
        bits and, per subframe, TB ok, DCI ok, CFI ok."""
        if stages is not None:
            torch.cuda.synchronize()
            stages.append(("start", time.perf_counter()))
        rx = s
        if snr_db is not None:
            sigma = torch.sqrt(torch.mean(torch.abs(s) ** 2) / (10.0 ** (snr_db / 10.0)) / 2.0)
            n = torch.randn((2,) + s.shape, generator=gen, device=s.device) * sigma
            rx = s + torch.complex(n[0], n[1])
        if stages is not None:
            torch.cuda.synchronize()
            stages.append(("awgn", time.perf_counter()))
        out = self.receive(rx, stages, siso_dtype)
        return out["bits"], out["tb_ok"], out["dci_ok"], out["cfi_ok"]


def reset_counts():
    from srslte_tpu_torch.ops import tdec_cuda, viterbi_cuda
    from srslte_tpu_torch.utils import jit

    jit.fold_launches()  # replays before this point count no more
    tdec_cuda.siso_windowed.launches = 0
    tdec_cuda.siso_windowed.launches_bf16 = 0
    viterbi_cuda.viterbi_decode.launches = 0


def read_counts():
    from srslte_tpu_torch.ops import tdec_cuda, viterbi_cuda
    from srslte_tpu_torch.utils import jit

    jit.fold_launches()  # the conditional bodies the replays ran
    return {"siso_windowed": tdec_cuda.siso_windowed.launches,
            "siso_windowed_bf16": tdec_cuda.siso_windowed.launches_bf16,
            "viterbi_decode": viterbi_cuda.viterbi_decode.launches}


def counted_dispatch(chain, s, snr_db, gen, siso_dtype=F32):
    """One dispatch of a path (DL `Chain` or `UlChain`) through `counted`."""
    return counted(lambda: chain.decode(s, snr_db, gen, siso_dtype=siso_dtype), siso_dtype)


def counted(run, siso_dtype=F32):
    """run() with the launch counts set to 0 just before and read just
    after; fails unless the SISO of `siso_dtype` and the Viterbi were
    launched.  Returns (run's result, the counts, the peak device memory in
    MB: (peak allocated, its rise over what was allocated before))."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    out = run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("siso_windowed_bf16" if siso_dtype == BF16 else "siso_windowed",
                 "viterbi_decode"):
        check(counts[name] > 0, f"the path did not launch the {name} kernel")
    return out, counts, (peak / 1e6, (peak - before) / 1e6)


def phase_clean(chain, bits, s):
    (dec, tb_ok, dci_ok, cfi_ok), counts, _ = counted_dispatch(chain, s, None, None)
    check(dec.shape == bits.shape and dec.dtype == torch.uint8, "decoded TB shape or type")
    check(bool(cfi_ok.all()), f"clean channel: CFI decoded in {int(cfi_ok.sum())}/{BATCH}")
    check(bool(dci_ok.all()), f"clean channel: DCI found in {int(dci_ok.sum())}/{BATCH}")
    check(bool(tb_ok.all()), f"clean channel: TB CRC ok in {int(tb_ok.sum())}/{BATCH}")
    check(bool((dec == bits).all()), "clean channel: decoded bits differ from the bits sent")
    print(f"[4 main path, clean] {BATCH} subframes: every CFI = {CFI}, DCI found with the "
          f"transmitted payload, every TB passes CRC and equals the bits sent; launches {counts}",
          flush=True)


def phase_noisy(chain, bits, s):
    """DL at SNR_DB: a counted dispatch in float32 and one in 16 bits on the
    same noise draw, then the timed dispatches; returns the launch counts of
    the two counted dispatches and the median dispatch time."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    (dec, tb_ok, dci_ok, cfi_ok), counts, mem = counted_dispatch(chain, s, SNR_DB, gen)
    n_ok = int(tb_ok.sum())
    check(int(cfi_ok.sum()) == BATCH, f"PCFICH decode failed: {int(cfi_ok.sum())}/{BATCH}")
    check(int(dci_ok.sum()) == BATCH, f"PDCCH blind search failed: {int(dci_ok.sum())}/{BATCH}")
    check(n_ok >= 0.8 * BATCH, f"BLER implausibly high: {n_ok}/{BATCH}")
    check(bool((dec[tb_ok] == bits[tb_ok]).all()), "a TB that passed CRC differs from the bits sent")
    print(f"[5 main path, {SNR_DB} dB] first dispatch: CFI {BATCH}/{BATCH}, DCI {BATCH}/{BATCH}, "
          f"TB ok {n_ok}/{BATCH}; kernel launches in this dispatch {counts}; peak device memory "
          f"{mem[0]:.1f} MB, {mem[1]:.1f} MB above what was allocated before it", flush=True)
    gen16 = torch.Generator(device="cuda")
    gen16.manual_seed(1234)  # the same noise draw as the float32 dispatch
    (dec16, tb16, dci16, cfi16), counts16, mem16 = counted_dispatch(chain, s, SNR_DB, gen16,
                                                                    siso_dtype=BF16)
    n16 = int(tb16.sum())
    check(bool(dci16.all()) and bool(cfi16.all()), "CFI or DCI lost in the 16-bit dispatch")
    check(n16 >= 0.8 * BATCH, f"16-bit SISO: BLER implausibly high: {n16}/{BATCH}")
    check(bool((dec16[tb16] == bits[tb16]).all()), "16-bit: a TB that passed CRC differs")
    print(f"[5 main path, {SNR_DB} dB] the same noise draw with the SISO in 16 bits: TB ok "
          f"{n16}/{BATCH} (float32: {n_ok}/{BATCH}), TB BLER {1 - n16 / BATCH:.4f} against "
          f"{1 - n_ok / BATCH:.4f}; launches {counts16}; peak device memory {mem16[0]:.1f} MB, "
          f"{mem16[1]:.1f} MB above what was allocated before it", flush=True)

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
    return counts, counts16, ms


class UlChain:
    """The UL deployment's objects and the two sides of its path."""

    def __init__(self):
        from srslte_tpu_torch.phy.common.params import Cell
        from srslte_tpu_torch.phy.enb.enb_ul import EnbUl
        from srslte_tpu_torch.phy.phch.pusch import Pusch
        from srslte_tpu_torch.phy.phch.ra_ul import UlGrant
        from srslte_tpu_torch.phy.phch.uci import UciCfgUl
        from srslte_tpu_torch.phy.ue.ue_ul import UeUl

        self.cell = Cell(n_prb=100, id=1, nof_ports=1)
        # 96 PRB: the largest DFT size (2^5 * 3) that leaves PRBs 0-1 and
        # 98-99 for PUCCH; 30-bit CQI: aperiodic mode 3-0 at 100 PRB
        self.pusch = Pusch(self.cell, UlGrant(prb_start=2, n_prb=96, mcs=28), UL_SF_IDX,
                           RNTI, UciCfgUl(o_ack=1, o_cqi=30))
        self.ue = UeUl(self.cell)
        self.enb = EnbUl(self.cell)
        cfg = self.pusch.cfg
        check((cfg.tbs, cfg.G, cfg.seg.C, cfg.seg.K1) == (71112, 82860, 12, 5952),
              f"unexpected UL-SCH bucket {cfg.tbs, cfg.G, cfg.seg.C, cfg.seg.K1}")

    def encode(self, seed):
        """BATCH subframes of stimulus: bits [B, tbs], ACK [B, 1] on the card,
        CQI [B, 30] on the host, samples [B, sf_len]."""
        rng = np.random.default_rng(seed)
        bits = torch.as_tensor(rng.integers(0, 2, (BATCH, self.pusch.grant.tbs), dtype=np.uint8),
                               device="cuda")
        ack = torch.as_tensor(rng.integers(0, 2, (BATCH, 1), dtype=np.uint8), device="cuda")
        cqi = rng.integers(0, 2, (BATCH, 30), dtype=np.uint8)
        s = self.ue.encode_pusch(self.pusch, bits, ack=ack, cqi=cqi)
        return bits, ack, torch.as_tensor(cqi, device="cuda"), s

    @staticmethod
    def noisy(s, snr_db, gen):
        """s with AWGN at snr_db drawn anew from `gen` (s itself for None)."""
        if snr_db is None:
            return s
        sigma = torch.sqrt(torch.mean(torch.abs(s) ** 2) / (10.0 ** (snr_db / 10.0)) / 2.0)
        n = torch.randn((2,) + s.shape, generator=gen, device=s.device) * sigma
        return s + torch.complex(n[0], n[1])

    def decode(self, s, snr_db, gen, siso_dtype=F32):
        """One dispatch of EnbUl.decode_pusch on BATCH subframes."""
        return self.enb.decode_pusch(self.noisy(s, snr_db, gen), self.pusch, siso_dtype=siso_dtype)


@contextlib.contextmanager
def wrapped(hooks, wrap):
    """While open, each function `owner.attr` of hooks ((owner, attr, name),
    ...) is replaced by wrap(function, name): an entry point's own stages are
    timed or counted, not a copy of its composition."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in hooks]
    for (owner, attr, fn), (_, _, name) in zip(saved, hooks):
        setattr(owner, attr, wrap(fn, name))
    try:
        yield [name for _, _, name in hooks]
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def eager(entries):
    """While open, each entry point `owner.attr` of entries ((owner, attr),
    ...) runs as its `__wrapped__`: eagerly, so that the hooks of a stage
    split see the functions a CUDA graph would replay."""
    return wrapped(tuple((owner, attr, attr) for owner, attr in entries),
                   lambda fn, name: fn.__wrapped__)


def stage_marks(stages, hooks=None):
    """While open, the stages that EnbUl.decode_pusch calls (or the functions
    of `hooks`) synchronise and append (stage name, host time) to `stages`
    as they return."""
    from srslte_tpu_torch.phy.chest.chest_ul import ChestUl
    from srslte_tpu_torch.phy.ofdm import Ofdm
    from srslte_tpu_torch.phy.phch import pusch

    if hooks is None:
        hooks = ((Ofdm, "rx_sf", "rx_sf"), (ChestUl, "estimate", "chest"),
                 (pusch.Pusch, "soft_bits", "equalise_deprecode_demod"),
                 (pusch.Pusch, "demux", "uci_demux_viterbi"),
                 (pusch, "dlsch_decode", "dlsch_decode"))

    def marked(fn, name):
        def call(*args, **kw):
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stages.append((name, time.perf_counter()))
            return out
        return call

    return wrapped(hooks, marked)


def ul_score(out, bits, ack, cqi):
    """(TB ok, ACK right, CQI right and its CRC8 passing) counts of a dispatch;
    fails if a TB that passed its CRC differs from the bits sent."""
    dec, tb_ok, info = out
    check(dec.shape == bits.shape and dec.dtype == torch.uint8, "decoded UL TB shape or type")
    check(bool((dec[tb_ok] == bits[tb_ok]).all()), "a UL TB that passed CRC differs from the bits sent")
    ack_ok = (info["ack"] == ack)[:, 0]
    cqi_ok = torch.all(info["cqi"] == cqi, dim=-1) & (info["cqi_metric"] == 1.0)
    return int(tb_ok.sum()), int(ack_ok.sum()), int(cqi_ok.sum())


def phase_ul(ul, bits, ack, cqi, s):
    """UL clean and at UL_SNR_DB, in both numerics; returns the launch counts
    of the counted noisy dispatch of each numerics ("ul_f32", "ul_bf16") and
    the float32 median dispatch time."""
    counts_ul = {}
    for dt in (F32, BF16):
        name = "float32" if dt == F32 else "16-bit"
        out, counts, _ = counted_dispatch(ul, s, None, None, dt)
        n_tb, n_ack, n_cqi = ul_score(out, bits, ack, cqi)
        check((n_tb, n_ack, n_cqi) == (BATCH,) * 3,
              f"UL clean, {name} SISO: TB {n_tb}, ACK {n_ack}, CQI {n_cqi} of {BATCH}")
        print(f"[6 UL path, clean, {name} SISO] {BATCH} subframes: every TB passes CRC and equals "
              f"the bits sent, every ACK and CQI right (CQI CRC8 passes); launches {counts}",
              flush=True)

    medians = {}
    for dt in (F32, BF16):
        name = "float32" if dt == F32 else "16-bit"
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4321)  # the same noise draws in both numerics
        out, counts, mem = counted_dispatch(ul, s, UL_SNR_DB, gen, dt)
        counts_ul["ul_f32" if dt == F32 else "ul_bf16"] = counts
        n_tb, n_ack, n_cqi = ul_score(out, bits, ack, cqi)
        check(n_tb >= 0.8 * BATCH, f"UL {name}: TB ok {n_tb}/{BATCH} below 80 %")
        check(min(n_ack, n_cqi) >= 0.99 * BATCH,
              f"UL {name}: ACK {n_ack}/{BATCH}, CQI {n_cqi}/{BATCH} below 99 %")
        print(f"[7 UL path, {UL_SNR_DB} dB, {name} SISO] first dispatch: TB ok {n_tb}/{BATCH}, "
              f"ACK {n_ack}/{BATCH}, CQI {n_cqi}/{BATCH}; kernel launches in this dispatch "
              f"{counts}; peak device memory {mem[0]:.1f} MB, {mem[1]:.1f} MB above what was "
              f"allocated before it", flush=True)
        totals = [n_tb, n_ack, n_cqi]
        times = []
        for _ in range(N_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ul.decode(s, UL_SNR_DB, gen, siso_dtype=dt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            totals = [a + b for a, b in zip(totals, ul_score(out, bits, ack, cqi))]
        n = BATCH * (N_TIMED + 1)
        check(totals[0] >= 0.8 * n and min(totals[1:]) >= 0.99 * n,
              f"UL {name} over {n} subframes: TB {totals[0]}, ACK {totals[1]}, CQI {totals[2]}")
        ms = float(np.median(times))
        medians[name] = ms
        msps = BATCH * ul.cell.ofdm.sf_len / (ms * 1e-3) / 1e6
        torch.cuda.synchronize()
        stages = [("start", time.perf_counter())]
        rx = ul.noisy(s, UL_SNR_DB, gen)
        torch.cuda.synchronize()
        stages.append(("awgn", time.perf_counter()))
        with stage_marks(stages) as names:
            ul.enb.decode_pusch(rx, ul.pusch, siso_dtype=dt)
        check([nm for nm, _ in stages] == ["start", "awgn"] + names,
              f"UL stages ran out of order: {[nm for nm, _ in stages]}")
        split = ", ".join(f"{nm} {(t - stages[i][1]) * 1e3:.2f}"
                          for i, (nm, t) in enumerate(stages[1:]))
        print(f"[7 UL path, {UL_SNR_DB} dB, {name} SISO] {N_TIMED} timed dispatches of {BATCH} "
              f"subframes: {[round(t, 3) for t in times]} ms, median {ms:.3f} ms/dispatch = "
              f"{msps:.2f} Msamples/s ({msps / REALTIME_MSPS:.2f} x real time at 100 PRB); over "
              f"{n} subframes TB BLER {1 - totals[0] / n:.4f}, ACK errors {n - totals[1]}, CQI "
              f"errors {n - totals[2]}")
        print(f"[7 UL path, {UL_SNR_DB} dB, {name} SISO] one more dispatch with a synchronise "
              f"after each stage, ms: {split}", flush=True)
    return counts_ul, medians["float32"]


def phase_gold():
    """The device Gold sequence against the host one, a few seeds at the
    UL scrambling sequence's length."""
    from srslte_tpu_torch.phy.common.sequence import gold_sequence, gold_sequence_device

    seeds = (0, 1, (0x46 << 14) | (2 << 9) | 1, 2**31 - 1)
    n = 82944
    got = gold_sequence_device(torch.tensor(seeds, device="cuda"), n).cpu().numpy()
    for seed, row in zip(seeds, got):
        check(bool((row == gold_sequence(seed, n)).all()),
              f"device Gold sequence differs from the host one for seed {seed:#x}")
    print(f"[8 gold] gold_sequence_device of {len(seeds)} seeds x {n} bits on the card equals "
          f"the host gold_sequence", flush=True)


def phase_gates():
    """The turbo BLER gates on CUDA tensors in both numerics: the stimulus of
    tests/test_bler_gates.py (same seeds, numpy on the host, 6 iterations).
    float32 misses fail the run; the 16-bit counts are printed.  Returns
    {(K, numerics): (block errors, trials)}."""
    from srslte_tpu_torch.phy.fec.tdec import turbo_decode
    from srslte_tpu_torch.phy.fec.turbo import turbo_encode_np

    out = {}
    for k, ebno, n, seed, want in GATES:
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, (n, k)).astype(np.uint8)
        d = turbo_encode_np(bits).astype(np.float32)
        sigma = np.sqrt(1.0 / (2.0 * (k / d.shape[-1]) * 10 ** (ebno / 10)))
        llr = (2 * d - 1) + sigma * rng.standard_normal(d.shape).astype(np.float32)
        llr_t = torch.as_tensor(llr, device="cuda")
        for dt in (F32, BF16):
            hard, _ = turbo_decode(llr_t, k, n_iter=6, siso_dtype=dt)
            errs = int((hard.cpu().numpy() != bits).any(axis=1).sum())
            name = "float32" if dt == F32 else "16-bit"
            met = errs == 0 if want == "none" else errs > 0
            out[(k, name)] = (errs, n)
            print(f"[9 BLER gates] K={k} Eb/N0 {ebno} dB, {name} SISO: {errs}/{n} block errors "
                  f"(gate: {'0' if want == 'none' else '> 0'}) -> {'met' if met else 'MISSED'}",
                  flush=True)
            if dt == F32:
                check(met, f"turbo BLER gate K={k} at {ebno} dB: {errs}/{n} block errors")
    phase_ldpc_gate()
    return out


def phase_ldpc_gate():
    """tests/test_bler_gates.py's LDPC gate on CUDA tensors (LDPC_GATE: the
    same seed and numpy stimulus; the codewords from the port's encoder,
    equal to the reference's): zero block errors, or the run fails."""
    from srslte_tpu_torch.phy.fec.ldpc import LdpcGraph, ldpc_decode, ldpc_encode

    bg, zc, ebno, n, seed, n_iter = LDPC_GATE
    g = LdpcGraph(bg, zc)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n, g.k)).astype(np.uint8)
    cw = ldpc_encode(torch.as_tensor(bits, device="cuda"), g).cpu().numpy().astype(np.float32)
    rate = g.k / (g.n_full - 2 * g.zc)
    sigma = np.sqrt(1.0 / (2.0 * rate * 10 ** (ebno / 10)))
    llr = (2 * cw - 1) + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr[:, : 2 * g.zc] = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ok = ldpc_decode(torch.as_tensor(llr, device="cuda"), g, n_iter=n_iter)
    errs = int((out.cpu().numpy() != bits).any(axis=1).sum())
    ms = (time.perf_counter() - t0) * 1e3
    print(f"[9 BLER gates] LDPC BG{bg} Zc {zc} Eb/N0 {ebno} dB, {n_iter} iterations: {errs}/{n} "
          f"block errors, {int(ok.sum())} parity checks passed (gate: 0) -> "
          f"{'met' if errs == 0 else 'MISSED'}; {ms:.1f} ms", flush=True)
    check(errs == 0, f"LDPC BLER gate BG{bg} Zc {zc} at {ebno} dB: {errs}/{n} block errors")


class HarqPath:
    """The DL deployment of `Chain` sending each TB at rv 0, 2, 3, 1
    (DlGrant.full(100, 27, rv)) and the UE's receive chain into the HARQ
    soft buffers."""

    def __init__(self, chain):
        from srslte_tpu_torch.mac.harq import RV_SEQ
        from srslte_tpu_torch.phy.phch.pdsch import Pdsch
        from srslte_tpu_torch.phy.phch.ra import DlGrant

        self.chain = chain
        self.pdsch = {rv: Pdsch(chain.cell, DlGrant.full(100, 27, rv=rv), SF_IDX, cfi=CFI,
                                rnti=RNTI) for rv in RV_SEQ}
        for rv, p in self.pdsch.items():
            check((p.cfg.tbs, p.cfg.G, p.cfg.seg.C, p.cfg.rv) == (63776, 82800, 11, rv),
                  f"unexpected DL-SCH bucket at rv {rv}")

    def encode(self, bits, rv):
        """The eNB's subframes carrying bits [n, tbs] at rv -> samples [n, sf_len]."""
        enb = self.chain.enb
        g = enb.put_base(enb.empty_grids((bits.shape[0],)), SF_IDX)
        g = enb.put_pcfich(g, SF_IDX, CFI)
        g = enb.put_pdsch(g, self.pdsch[rv], bits)
        return enb.gen_signal(g)[..., 0, :]

    def front_end(self, s, rv, gen):
        """AWGN at HARQ_SNR_DB -> UeDl.fft_estimate -> Pdsch.soft_bits:
        (LLRs [n, G], (grid, ce, noise))."""
        grid, ce, info = self.chain.ue.fft_estimate(UlChain.noisy(s, HARQ_SNR_DB, gen), SF_IDX)
        return self.pdsch[rv].soft_bits(grid, ce, info["noise"]), (grid, ce, info["noise"])


def combine_and_decode(llr, cfg, state, pending):
    """The receiver's HARQ step for the TBs `pending`: their LLRs combined
    into their soft buffers (new ones when `state` is None), then decoded:
    (their soft buffers, (bits, crc_ok))."""
    from srslte_tpu_torch.mac.harq import combine_llr, decode_state

    sub = combine_llr(llr, cfg, None if state is None else tuple(w[pending] for w in state))
    return sub, decode_state(sub, cfg)


def phase_harq(chain, rng_kernels, profile=False):
    """DL HARQ over BATCH TBs: rv 0 to all, then rv 2, 3, 1 to the TBs still
    failing; per round combine_llr into each TB's soft buffer and
    decode_state.  Checks that the decoded share rises every round while TBs
    are pending, reaches 99 % after four transmissions, and that every decoded
    TB equals the bits sent.  Returns the SISO launch counts of all rounds
    and the ms of round 1's combine + decode."""
    from srslte_tpu_torch.mac.harq import RV_SEQ

    h = HarqPath(chain)
    rng = np.random.default_rng(HARQ_SEED)
    tbs = h.pdsch[0].cfg.tbs
    bits = torch.as_tensor(rng.integers(0, 2, (BATCH, tbs), dtype=np.uint8), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(HARQ_SEED)
    done = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
    pending = torch.arange(BATCH, device="cuda")
    state, shares, total, round1_ms = None, [], {}, None
    for rnd, rv in enumerate(RV_SEQ, 1):
        n = int(pending.numel())
        if n == 0:
            break
        s = h.encode(bits[pending], rv)
        llr, (grid, ce, noise) = h.front_end(s, rv, gen)
        cfg = h.pdsch[rv].cfg
        if rnd == 2:
            if 11 * n != HARQ_RAGGED[0]:  # hold the kernel at this round's own shape too
                check_siso(rng_kernels, 11 * n, *HARQ_RAGGED[1:])
            alone, ok_alone = h.pdsch[rv].decode(grid, ce, noise)
            n_alone = int(ok_alone.sum())
            check(bool((alone[ok_alone] == bits[pending][ok_alone]).all()),
                  "rv 2 alone: a TB that passed CRC differs from the bits sent")
        del grid, ce
        reset_counts()
        (sub, (dec, ok)), ms, peak = timed(lambda: combine_and_decode(llr, cfg, state, pending))
        counts = read_counts()
        check(counts["siso_windowed"] > 0, f"HARQ round {rnd} did not launch the SISO kernel")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if state is None:
            state = sub
        else:
            for w, ws in zip(state, sub):
                w[pending] = ws
        check(dec.shape == (n, tbs) and dec.dtype == torch.uint8, "decoded HARQ TB shape or type")
        check(bool((dec[ok] == bits[pending][ok]).all()),
              f"HARQ round {rnd}: a TB that passed CRC differs from the bits sent")
        done[pending[ok]] = True
        pending = pending[~ok]
        share = float(done.float().mean())
        check(not shares or share > shares[-1],
              f"HARQ round {rnd} (rv {rv}) decoded nothing more: share {share}")
        shares.append(share)
        if rnd == 1:
            round1_ms = ms
        extra = (f"; the rv 2 transmission alone through Pdsch.decode: {n_alone}/{n} decoded"
                 if rnd == 2 else "")
        print(f"[10 DL HARQ, {HARQ_SNR_DB} dB] round {rnd} (rv {rv}): {n} TBs sent, "
              f"{int(ok.sum())} newly decoded, decoded share {share:.4f} "
              f"({int(done.sum())}/{BATCH}); combine_llr + decode_state {ms:.3f} ms on "
              f"{11 * n} code blocks; launches {counts}; peak device memory {peak}; soft "
              f"buffers {sum(w.numel() * 4 for w in state) / 1e6:.1f} MB{extra}", flush=True)
        if profile and rnd == 1:
            phase_profile("DL HARQ round 1", lambda: combine_and_decode(llr, cfg, None, None), ms)
    check(shares[-1] >= 0.99, f"HARQ: decoded share {shares[-1]} after {len(shares)} "
                              f"transmissions, below 99 %")
    print(f"[10 DL HARQ, {HARQ_SNR_DB} dB] decoded share per round {shares}, residual TB BLER "
          f"{1 - shares[-1]:.4f}; every decoded TB equals the bits sent; SISO launches over the "
          f"rounds {total['siso_windowed']}", flush=True)
    return total, round1_ms


class UlControl:
    """The eNB's UL control stimuli from the port's UE side: PUCCH of ten
    resources (six 1a ACKs, an empty 1a resource, a format 1 SR, a 2b with a
    wideband CQI and 2 ACK bits, a format 3 with 10 ACK bits), SRS and
    PRACH."""

    def __init__(self):
        from srslte_tpu_torch.phy.common.params import Cell
        from srslte_tpu_torch.phy.enb.enb_ul import EnbUl
        from srslte_tpu_torch.phy.phch.prach import PrachConfig
        from srslte_tpu_torch.phy.phch.pucch import Pucch, PucchConfig
        from srslte_tpu_torch.phy.phch.srs import Srs, srs_config_from_bw
        from srslte_tpu_torch.phy.ue.ue_ul import UeUl

        self.cell = Cell(n_prb=100, id=1, nof_ports=1)
        self.ue, self.enb = UeUl(self.cell), EnbUl(self.cell)
        f1 = lambda fmt, n: Pucch(self.cell, PucchConfig(fmt, n, n_rb_2=N_RB_2), UL_SF_IDX, RNTI)
        self.acks = [f1("1a", N1_PUCCH_AN + c) for c in ACK_NCCE]
        self.dtx = f1("1a", N1_PUCCH_AN + DTX_NCCE)
        self.sr = f1("1", RNTI % 12)
        self.f2b = Pucch(self.cell, PucchConfig("2b", N_PUCCH_2, n_rb_2=N_RB_2), UL_SF_IDX, RNTI)
        self.f3 = Pucch(self.cell, PucchConfig("3", N_PUCCH_3, n_rb_2=N_RB_2), UL_SF_IDX, RNTI)
        self.srs = Srs(self.cell, srs_config_from_bw(100, bw_cfg=0, b_srs=0, n_rrc=0))
        check(self.srs.cfg.m_srs == 96, "SRS C_SRS 0 at 100 PRB is not 96 PRB")
        self.prach = PrachConfig(self.cell.ofdm, root_seq_idx=0, zero_corr_cfg=7)
        check((self.prach.n_cs, self.prach.n_fft) == (38, 24576), "unexpected PRACH config")
        # the formats' RE sets: every format-1 resource (CDM inside one PRB
        # pair), the empty resource, format 2b and format 3 pairwise disjoint
        res = lambda p: set(p.re_indices().tolist())
        groups = {"format 1": set().union(*map(res, self.acks + [self.sr])),
                  "empty 1a": res(self.dtx), "format 2b": res(self.f2b), "format 3": res(self.f3)}
        for (a, ra), (b, rb) in itertools.combinations(groups.items(), 2):
            check(not ra & rb, f"PUCCH {a} and {b} share resource elements")
        self.groups = groups

    def pucch_stimulus(self, rng, gen):
        """BATCH subframes: the payloads and the eNB's received samples (the
        UEs' signals summed, AWGN at PUCCH_SNR_DB per occupied RE)."""
        from srslte_tpu_torch.phy.phch.cqi import WidebandCqi

        pay = {"acks": rng.integers(0, 2, (BATCH, len(self.acks), 1), dtype=np.uint8),
               "cqi": rng.integers(0, 16, BATCH),
               "ack2": rng.integers(0, 2, (BATCH, 2), dtype=np.uint8),
               "ack3": rng.integers(0, 2, (BATCH, 10), dtype=np.uint8)}
        pay["cqi_bits"] = np.stack([WidebandCqi(cqi=int(c)).pack() for c in pay["cqi"]])
        s = self.ue.encode_pucch(self.sr, device="cuda").expand(BATCH, -1)
        for i, p in enumerate(self.acks):
            s = s + self.ue.encode_pucch(p, ack_bits=pay["acks"][:, i], device="cuda")
        s = s + self.ue.encode_pucch(self.f2b, ack_bits=pay["ack2"], cqi_bits=pay["cqi_bits"],
                                     device="cuda")
        s = s + self.ue.encode_pucch(self.f3, ack_bits=pay["ack3"], device="cuda")
        return pay, s + noise_like(s, 10 ** (-PUCCH_SNR_DB / 10), gen)

    def decode_pucch(self, rx, times=None):
        """EnbUl.decode_pucch once per UE resource, each over the batch."""
        calls = [("ack", p, {}) for p in self.acks] + [
            ("dtx", self.dtx, {}), ("sr", self.sr, {}), ("f2b", self.f2b, {"nof_cqi_bits": 4}),
            ("f3", self.f3, {"nof_ack3_bits": 10})]
        out = []
        for name, p, kw in calls:
            if times is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out.append((name, self.enb.decode_pucch(rx, p, **kw)))
            if times is not None:
                torch.cuda.synchronize()
                times.append((name, (time.perf_counter() - t0) * 1e3))
        return out


def noise_like(s, var, gen):
    """Complex AWGN of variance var per sample (per RE after the unitary
    SC-FDMA demodulator), shaped like s."""
    n = torch.randn((2,) + s.shape, generator=gen, device=s.device) * math.sqrt(var / 2)
    return torch.complex(n[0], n[1])


def timed(fn):
    """(fn(), host ms, peak device memory) of one call that ends in a
    synchronise; the memory as "peak MB (MB above what was allocated
    before)"."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    return out, ms, (f"{peak / 1e6:.1f} MB ({(peak - before) / 1e6:.1f} MB above what was "
                     f"allocated before)")


def phase_ul_control(profile=False):
    """PUCCH, SRS and PRACH of the eNB at 100 PRB, 128 subframes or windows
    per dispatch; checks the decisions (see the module docstring)."""
    from srslte_tpu_torch.phy.phch.prach import prach_detect, prach_gen

    uc = UlControl()
    rng = np.random.default_rng(53)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(53)
    print(f"[11 UL control] PUCCH resources at subframe {UL_SF_IDX}: 1a ACKs n_pucch "
          f"{[p.cfg.n_pucch for p in uc.acks]}, empty 1a {uc.dtx.cfg.n_pucch}, SR "
          f"{uc.sr.cfg.n_pucch}, 2b {N_PUCCH_2}, 3 {N_PUCCH_3}; RE sets of the formats "
          f"pairwise disjoint ({', '.join(f'{k} {len(v)}' for k, v in uc.groups.items())} REs)",
          flush=True)
    # the noise per RE after EnbUl's SC-FDMA demodulation, from noise alone
    probe = uc.enb.ofdm.rx_sf(noise_like(torch.zeros((8, 30720), dtype=torch.complex64,
                                                     device="cuda"), 1.0, gen))
    per_re = float(torch.mean(torch.abs(probe) ** 2))
    check(abs(per_re - 1.0) < 0.01, f"SC-FDMA demodulator not unitary: {per_re}")

    # --- PUCCH ---
    pay, rx = uc.pucch_stimulus(rng, gen)
    uc.decode_pucch(rx)  # warm-up: tables built and uploaded
    times = []
    out, total_ms, peak = timed(lambda: uc.decode_pucch(rx, times))
    res = dict()
    acks = [o for name, o in out if name == "ack"]
    ack_metrics = [a["metric"] for a in acks]
    right = [int(((o["ack"].cpu().numpy()[:, 0] == pay["acks"][:, i, 0])).sum())
             for i, o in enumerate(acks)]
    o = dict((name, o) for name, o in out if name != "ack")
    dtx_metric = o["dtx"]["metric"].cpu().numpy()
    res["sr"] = int(o["sr"]["detected"].sum())
    cqi_ok = np.all(o["f2b"]["cqi"].cpu().numpy() == pay["cqi_bits"], axis=-1)
    ack2_ok = np.all(o["f2b"]["ack"].cpu().numpy() == pay["ack2"], axis=-1)
    res["f2b"] = int((cqi_ok & ack2_ok).sum())
    res["f3"] = int(np.all(o["f3"]["ack"].cpu().numpy() == pay["ack3"], axis=-1).sum())
    res["dtx"] = int((dtx_metric < ACK_DET_THRESH).sum())
    need = math.ceil(0.99 * BATCH)
    for i, r in enumerate(right):
        check(r >= need, f"PUCCH 1a UE {i}: ACK right in {r}/{BATCH}")
    check(res["sr"] >= need, f"PUCCH SR detected in {res['sr']}/{BATCH}")
    check(res["f2b"] >= need, f"PUCCH 2b CQI and ACK right in {res['f2b']}/{BATCH}")
    check(res["f3"] >= need, f"PUCCH 3: 10 ACK bits right in {res['f3']}/{BATCH}")
    print(f"[11 UL control, PUCCH {PUCCH_SNR_DB} dB per RE] {BATCH} subframes: 1a ACK right per "
          f"UE {right}; SR detected {res['sr']}; 2b CQI + 2 ACK bits right {res['f2b']}; "
          f"format 3 10 bits right {res['f3']} (each of {BATCH}, >= {need} required)", flush=True)
    print(f"[11 UL control, PUCCH] empty 1a resource (DTX): metric below ACK_DET_THRESH "
          f"{ACK_DET_THRESH} in {res['dtx']}/{BATCH} subframes; metric median "
          f"{float(np.median(dtx_metric)):.3f}, 1st/99th percentile "
          f"{float(np.percentile(dtx_metric, 1)):.3f}/{float(np.percentile(dtx_metric, 99)):.3f}; "
          f"the six ACK resources' median {float(torch.median(torch.cat(ack_metrics))):.3f}",
          flush=True)
    print(f"[11 UL control, PUCCH] EnbUl.decode_pucch over {BATCH} subframes, ms per UE call: "
          f"{', '.join(f'{n} {t:.3f}' for n, t in times)}; total {total_ms:.3f} ms for "
          f"{len(times)} calls; peak device memory {peak}", flush=True)

    # --- SRS ---
    o = uc.cell.ofdm
    h_true = 0.8 * np.exp(0.5j)
    var = 10 ** (-SRS_SNR_DB / 10)
    g = uc.srs.encode(torch.zeros((BATCH, o.nsymb_sf, o.nof_re), dtype=torch.complex64,
                                  device="cuda"))
    s_srs = uc.ue.ofdm.tx_sf(g) * complex(h_true)
    s_srs = s_srs + noise_like(s_srs, var, gen)
    uc.srs.estimate(uc.enb.ofdm.rx_sf(s_srs))  # warm-up
    (h, noise, power), srs_ms, srs_peak = timed(
        lambda: uc.srs.estimate(uc.enb.ofdm.rx_sf(s_srs)))
    rel = noise.cpu().numpy() / var - 1
    h_err = abs(complex(h.mean().cpu()) - h_true)
    check(float(np.abs(rel).max()) <= 0.2, f"SRS noise estimate off by {float(np.abs(rel).max())}")
    check(h_err < 0.05, f"SRS channel estimate off by {h_err}")
    print(f"[11 UL control, SRS {SRS_SNR_DB} dB] {BATCH} symbols of {uc.srs.cfg.m_sc} comb REs "
          f"(96 PRB): noise estimate / true noise {1 + float(rel.min()):.4f} to "
          f"{1 + float(rel.max()):.4f} (within 20 % required), mean channel error {h_err:.4f}; "
          f"rx_sf + Srs.estimate {srs_ms:.3f} ms per dispatch, peak device memory "
          f"{srs_peak}", flush=True)

    # --- PRACH ---
    cfg = uc.prach
    idx = (7 * np.arange(BATCH)) % 64
    delay = rng.integers(0, PRACH_MAX_DELAY, BATCH)
    win = cfg.n_total + PRACH_MAX_DELAY
    x = np.zeros((BATCH, win), np.complex64)
    for i in range(BATCH):
        x[i, delay[i] : delay[i] + cfg.n_total] = prach_gen(cfg, int(idx[i]))
    xs = torch.as_tensor(x, device="cuda")
    xs = xs + noise_like(xs, 10 ** (-PRACH_SNR_DB / 10), gen)
    prach_detect(cfg, xs)  # warm-up
    (det, metric, toff), prach_ms, prach_peak = timed(lambda: prach_detect(cfg, xs))
    det, toff = det.cpu().numpy(), toff.cpu().numpy()
    rows = np.arange(BATCH)
    hit = det[rows, idx]
    lag = cfg.n_fft / cfg.nzc
    t_err = np.abs(toff[rows, idx].astype(np.int64) - delay)
    others = int(det.sum() - hit.sum())
    check(bool(hit.all()), f"PRACH: {int(hit.sum())}/{BATCH} preambles detected at their index")
    check(float(t_err.max()) <= lag + 1, f"PRACH timing off by {int(t_err.max())} samples")
    noise_only = noise_like(xs, 1.0, gen)
    det0 = prach_detect(cfg, noise_only)[0]
    false = int(det0.sum())
    check(false <= 4, f"PRACH: {false} false detections on noise alone")
    roots = torch.zeros((BATCH, cfg.n_roots, cfg.nzc), dtype=torch.complex64, device="cuda")
    ifft_ms = event_ms(lambda: torch.fft.ifft(roots, dim=-1), 20)
    roots_p2 = torch.zeros((BATCH, cfg.n_roots, 1024), dtype=torch.complex64, device="cuda")
    ifft2_ms = event_ms(lambda: torch.fft.ifft(roots_p2, dim=-1), 20)
    print(f"[11 UL control, PRACH {PRACH_SNR_DB} dB] {BATCH} format 0 windows (root 0, N_cs "
          f"{cfg.n_cs}, {cfg.n_roots} roots): every preamble detected at its index, timing within "
          f"{int(t_err.max())} samples (one lag {lag:.1f}), {others} other detections; noise "
          f"alone: {false} false detections in {BATCH} x 64 hypotheses; prach_detect "
          f"{prach_ms:.3f} ms per dispatch, peak device memory {prach_peak}; the "
          f"{cfg.nzc}-point IFFT of [{BATCH}, {cfg.n_roots}] rows alone {ifft_ms:.4f} ms "
          f"(1024 points: {ifft2_ms:.4f} ms)", flush=True)
    if profile:
        phase_profile("UL control", lambda: (uc.decode_pucch(rx),
                                             uc.srs.estimate(uc.enb.ofdm.rx_sf(s_srs)),
                                             prach_detect(cfg, xs)),
                      total_ms + srs_ms + prach_ms)


def blind_capture(cell, device=None):
    """The capture: BLIND_FRAMES frames encoded on the card by the port's
    example eNB (`make_frame`), written by `FileSink` to a file in a
    temporary directory and read back by `FileSource`.  Returns (samples
    [L] complex64 numpy, the bits of a frame [10, tbs], ms, file bytes)."""
    from srslte_tpu_torch.examples.pdsch_enodeb import make_frame
    from srslte_tpu_torch.phy.io import FileSink, FileSource

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.bin")
        sink = FileSink(path)
        for sfn in range(BLIND_FRAMES):
            s, bits = make_frame(cell, BLIND_RNTI, BLIND_MCS, sfn, BLIND_SEED, device)
            sink.write(s.reshape(-1).cpu().numpy())
        sink.close()
        nbytes = os.path.getsize(path)
        src = FileSource(path)
        samples = src.read(10**9)
        src.close()
    return samples, bits, (time.perf_counter() - t0) * 1e3, nbytes


def blind_impaired(a, fft_size, seed=BLIND_NOISE_SEED):
    """Stream B: BLIND_DELAY samples of silence, a CFO of BLIND_CFO
    subcarriers and AWGN BLIND_SNR_DB below a's mean power per sample, drawn
    on the host from `seed`."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.zeros(BLIND_DELAY, np.complex64), a])
    x = x * np.exp(2j * np.pi * BLIND_CFO * np.arange(len(x)) / fft_size)
    sigma = np.sqrt(np.mean(np.abs(a) ** 2) / 10 ** (BLIND_SNR_DB / 10) / 2)
    x = x + sigma * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


def blind_receive(x, receive=None):
    """`receive` of the port's example (or the one given) on stream x."""
    if receive is None:
        from srslte_tpu_torch.examples.pdsch_ue import receive
    return receive(x, BLIND_PRB, BLIND_RNTI, max_sf=BLIND_MAX_SF)


def blind_score(out, cell, dci, bits, name, dci_in_every=True):
    """Checks the cell, the MIB (n_prb, the PHICH fields sent, an SFN that
    is a multiple of 4), that the receiver emitted every subframe after the
    first lock (it stopped at the end of the stream), the DCI sent in every
    subframe (unless `dci_in_every` is False), and that every TB that passed
    its CRC equals the bits sent.
    Returns (subframes, CFI right, TB ok, the CRC flags as a string of 0/1)."""
    check(out["cell"] is not None and out["cell"].id == cell.id,
          f"{name}: cell search found {out['cell']}")
    mib = out["mib"]
    check(mib is not None and (mib.n_prb, mib.phich_length, mib.phich_resources)
          == (cell.n_prb, cell.phich_length, cell.phich_resources) and mib.sfn % 4 == 0,
          f"{name}: MIB {mib}")
    res = out["results"]
    check(10 * (BLIND_FRAMES - 1) <= len(res) < BLIND_MAX_SF and len(res) % 5 == 0,
          f"{name}: {len(res)} subframes emitted")
    n_dci = sum(r["dci"] == dci for r in res)
    check(n_dci == len(res) or not dci_in_every,
          f"{name}: the DCI sent found in {n_dci}/{len(res)} subframes")
    ok = [r for r in res if r["crc_ok"]]
    for r in ok:
        check(bool((r["bits"] == bits[r["sf_idx"]]).all()),
              f"{name}: a TB that passed CRC in subframe {r['sf_idx']} differs from the bits sent")
    crc = "".join(str(int(r["crc_ok"])) for r in res)
    return len(res), sum(r["cfi"] == CFI for r in res), len(ok), crc


def blind_hooks():
    """The stages of `receive`, as (owner, attribute, name)."""
    from srslte_tpu_torch.examples import pdsch_ue
    from srslte_tpu_torch.phy.phch.pcfich import Pcfich
    from srslte_tpu_torch.phy.phch.pdcch import Pdcch
    from srslte_tpu_torch.phy.phch.pdsch import Pdsch
    from srslte_tpu_torch.phy.ue.ue_dl import UeDl
    from srslte_tpu_torch.phy.ue.ue_mib import UeMib
    from srslte_tpu_torch.phy.ue.ue_sync import UeSync

    return ((pdsch_ue, "cell_search", "cell_search"), (UeSync, "find", "find"),
            (UeSync, "track_block", "track_block"), (UeMib, "decode", "mib"),
            (UeDl, "fft_estimate", "fft_estimate"), (Pcfich, "decode", "pcfich"),
            (Pdcch, "search", "pdcch_search"), (Pdsch, "decode", "pdsch_decode"))


def call_timer(times):
    """A `wrapped` wrap: each call synchronises before and after and appends
    (name, ms) to `times`."""
    def wrap(fn, name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times.append((name, (time.perf_counter() - t0) * 1e3))
            return out
        return call
    return wrap


def cfo_recorder(cfos):
    """A `wrapped` wrap of UeSync.track_block: appends the CFO of the state
    each call returns."""
    def wrap(fn, name):
        def call(*args, **kw):
            sfs, state = fn(*args, **kw)
            cfos.append(state.cfo)
            return sfs, state
        return call
    return wrap


def count_syncs(run, hooks):
    """run() with the CUDA sync debug mode on "warn": each operation that
    makes the host wait for the card (`.item()`, a copy to the host, ...)
    raises one warning.  Returns (run's result, synchronising operations,
    {stage name: those inside the stage})."""
    per = {}

    def is_sync(w):
        return "synchroniz" in str(w.message)

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def counting(fn, name):
            def call(*args, **kw):
                n0 = len(seen)
                out = fn(*args, **kw)
                per[name] = per.get(name, 0) + sum(map(is_sync, seen[n0:]))
                return out
            return call

        torch.cuda.set_sync_debug_mode("warn")
        try:
            with wrapped(hooks, counting):
                out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(map(is_sync, seen)), per


def phase_blind(profile=False):
    """Blind receive from a capture at 20 MHz (see the module docstring):
    stream A clean, stream B impaired; the receive timed whole, by stage,
    and with its host synchronisations counted.  Returns the kernel launch
    counts of stream A's counted receive."""
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.phy.phch.dci import Dci1A
    from srslte_tpu_torch.phy.phch.pdsch import Pdsch
    from srslte_tpu_torch.phy.ue.ue_sync import UeSync

    cell = Cell(n_prb=BLIND_PRB, id=BLIND_CELL_ID, nof_ports=1)
    dci = Dci1A(rb_start=0, l_crb=BLIND_PRB, mcs=BLIND_MCS)
    cfg = Pdsch(cell, dci.grant(BLIND_PRB, BLIND_RNTI), 4, cfi=CFI, rnti=BLIND_RNTI).cfg
    check((cfg.tbs, cfg.seg.C, cfg.seg.K1) == BLIND_BUCKET,
          f"unexpected blind DL-SCH bucket {cfg.tbs, cfg.seg.C, cfg.seg.K1}")
    a, bits, enc_ms, nbytes = blind_capture(cell)
    L = BLIND_FRAMES * 10 * cell.ofdm.sf_len
    check(a.shape == (L,) and a.dtype == np.complex64 and bool(np.isfinite(a).all()),
          f"capture shape, type or values: {a.shape} {a.dtype}")
    b = blind_impaired(a, cell.ofdm.symbol_sz)
    print(f"[12 blind receive] capture: {BLIND_FRAMES} frames (SFN 0-{BLIND_FRAMES - 1}) of cell "
          f"{BLIND_CELL_ID} encoded on the card by make_frame, through FileSink and FileSource "
          f"({nbytes} bytes) in {enc_ms:.1f} ms; stream A {len(a)} samples, stream B {len(b)} "
          f"samples (delay {BLIND_DELAY}, CFO {BLIND_CFO}, AWGN {BLIND_SNR_DB} dB below the "
          f"mean power per sample)", flush=True)

    _, first_ms, _ = timed(lambda: blind_receive(a))  # tables built and uploaded
    cfos = []
    reset_counts()
    with wrapped(((UeSync, "track_block", "track_block"),), cfo_recorder(cfos)):
        out_a, ms_a, peak_a = timed(lambda: blind_receive(a))
    counts_a = read_counts()
    for name in ("siso_windowed", "viterbi_decode"):
        check(counts_a[name] > 0, f"the blind receive did not launch the {name} kernel")
    n_a, cfi_a, ok_a, crc_a = blind_score(out_a, cell, dci, bits, "stream A")
    check(cfi_a == n_a and ok_a >= BLIND_JAX_TB_OK_A,
          f"stream A: CFI {cfi_a}, TB ok {ok_a} of {n_a} subframes (CRC {crc_a}; the JAX "
          f"receiver: {BLIND_JAX_TB_OK_A})")
    msps = len(a) / (ms_a * 1e-3) / 1e6
    print(f"[12 blind receive, stream A] cell {out_a['cell'].id}, {out_a['mib']}; {n_a} subframes "
          f"emitted: CFI {cfi_a}/{n_a}, DCI {n_a}/{n_a}, TB ok {ok_a}/{n_a} (>= "
          f"{BLIND_JAX_TB_OK_A}, the JAX receiver's count, required), CRC per subframe {crc_a}, "
          f"every passing TB equal to the bits sent; CFO after each block "
          f"{[round(c, 5) for c in cfos]}; kernel launches {counts_a}", flush=True)
    print(f"[12 blind receive, stream A] receive {ms_a:.3f} ms (first call, tables built: "
          f"{first_ms:.3f} ms) = {msps:.2f} Msamples/s of the stream ({msps / REALTIME_MSPS:.3f} x "
          f"real time at 100 PRB); peak device memory {peak_a}", flush=True)

    times = []
    with wrapped(blind_hooks(), call_timer(times)):
        blind_receive(a)
    by = {}
    for name, ms in times:
        by.setdefault(name, []).append(ms)
    each = {n: ", ".join(f"{t:.3f}" for t in by.get(n, []))
            for n in ("cell_search", "find", "track_block", "mib")}
    med = ", ".join(f"{n} {float(np.median(by[n])):.3f}"
                    for n in ("fft_estimate", "pcfich", "pdcch_search", "pdsch_decode"))
    print(f"[12 blind receive, stream A] one more receive with a synchronise around each stage, "
          f"ms: cell_search {each['cell_search']}; UeSync.find {each['find']}; track_block "
          f"[{each['track_block']}]; UeMib.decode {each['mib']}; median per subframe: {med}",
          flush=True)

    _, n_sync, per = count_syncs(lambda: blind_receive(a), blind_hooks())
    check(n_sync >= n_a, f"the sync debug mode saw {n_sync} synchronising operations "
                         f"in {n_a} subframes")
    print(f"[12 blind receive, stream A] host synchronisations (CUDA sync debug mode): {n_sync} "
          f"in one receive = {n_sync / n_a:.2f} per emitted subframe; by stage {per}", flush=True)

    reset_counts()
    out_b, ms_b, peak_b = timed(lambda: blind_receive(b))
    counts_b = read_counts()
    n_b, cfi_b, ok_b, crc_b = blind_score(out_b, cell, dci, bits, "stream B")
    check(ok_b >= BLIND_TB_OK * n_b,
          f"stream B: TB ok {ok_b}/{n_b} below {BLIND_TB_OK:.0%} (CRC {crc_b})")
    print(f"[12 blind receive, stream B] cell {out_b['cell'].id}, {out_b['mib']}; {n_b} subframes "
          f"emitted: CFI {cfi_b}/{n_b}, DCI {n_b}/{n_b}, TB ok {ok_b}/{n_b} (>= "
          f"{BLIND_TB_OK:.0%} required), CRC per subframe {crc_b}, every passing TB equal to "
          f"the bits sent; receive "
          f"{ms_b:.3f} ms; kernel launches {counts_b}; peak device memory {peak_b}", flush=True)
    if profile:
        phase_profile("blind receive, stream A", lambda: blind_receive(a), ms_a)
    return counts_a, (a, bits, cell, dci, out_a["mib"])


# ------------------------------------------------------- spatial multiplexing
class SmChain:
    """The spatial-multiplexing deployment of phases 13-15 and the two sides
    of its path: `Cell(n_prb=100, id=1, nof_ports=ports)`, FDD, normal CP,
    PHICH Ng 1 (normal duration unless `phich_length="ext"`), CFI `cfi`,
    subframe 4, RNTI 0x46; PCFICH, a random ACK / NACK / off pattern on every
    PHICH sequence, DCI 2 (`tm` 4) or 2A (`tm` 3) over all 25 RBGs at mcs
    (27, 27) at the first L=8 UE-specific location, and both TBs through
    `PdschSm` (2 ports) or `PdschSm4` (4 ports, `pmi4` the path's own: the
    JAX package maps no 4-port TPMI); the channel `SM_H2` or the 4x4 of
    `SM4_H_SEED`, one rx antenna per port.  `device` and `chest` let
    tests/rehearse_sm.py build the same stimulus on the CPU."""

    def __init__(self, ports=2, tm=4, pmi4=0, device="cuda", chest="average", cfi=CFI,
                 phich_length="norm"):
        from srslte_tpu_torch.phy.common.params import Cell
        from srslte_tpu_torch.phy.enb.enb_dl import EnbDl
        from srslte_tpu_torch.phy.phch import dci as D
        from srslte_tpu_torch.phy.phch.pcfich import Pcfich
        from srslte_tpu_torch.phy.phch.pdcch import (Pdcch, common_locations, rnti_mask,
                                                     ue_locations)
        from srslte_tpu_torch.phy.phch.phich import Phich
        from srslte_tpu_torch.phy.ue.ue_dl import UeDl

        self.ports, self.tm, self.pmi4, self.cfi, self.device = ports, tm, pmi4, cfi, device
        self.cell = Cell(n_prb=100, id=1, nof_ports=ports, phich_length=phich_length)
        fmt2a = ports == 2 and tm == 3
        self.pack = D.pack_format2a if fmt2a else D.pack_format2
        self.unpack = D.unpack_format2a if fmt2a else D.unpack_format2
        self.dci = D.Dci2(rbg_bitmask=(1 << 25) - 1, mcs=SM_MCS,
                          pinfo=SM_PINFO if (ports == 2 and tm == 4) else 0)
        self.dci_bits = self.pack(self.dci, 100, ports)
        self.dci_len = len(self.dci_bits)
        self.pdsch = self.pdsch_for(self.dci)
        self.scheduled = {self.dci: self.pdsch}  # the PDSCH of each DCI read back
        self.enb = EnbDl(self.cell)
        self.ue = UeDl(self.cell, chest_algorithm=chest)
        self.pcfich = Pcfich(self.cell, SF_IDX)
        self.phich = Phich(self.cell, SF_IDX)
        self.pd = Pdcch(self.cell, cfi, SF_IDX)
        locs = ue_locations(self.pd.n_cce, RNTI, SF_IDX)
        self.tx_loc = [l for l in locs if l.L == 8][0]
        locs += [l for l in common_locations(self.pd.n_cce) if l not in locs]
        groups = {}
        for l in locs:
            groups.setdefault(l.L, []).append(l)
        self.groups = tuple(tuple(g) for g in groups.values())
        self.n_cand = len(locs)
        self.mask = torch.as_tensor(rnti_mask(RNTI), device=device)
        self.dci_bits_t = torch.as_tensor(self.dci_bits, device=device)
        if ports == 2:
            h = np.array(SM_H2, np.complex64)
        else:
            rng = np.random.default_rng(SM4_H_SEED)
            h = ((rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))) / np.sqrt(2)
                 + 2 * np.eye(4)).astype(np.complex64)
        self.h = torch.as_tensor(h, device=device)
        for q in range(2):
            cfg = self.pdsch.cfg_q(q)
            check((cfg.tbs, cfg.seg.C, cfg.seg.K1) == (63776, 11, 5824),
                  f"unexpected SM DL-SCH bucket {cfg.tbs, cfg.seg.C, cfg.seg.K1}")

    def pdsch_for(self, dci):
        """The PDSCH a DCI schedules: both grants; at 2 ports the pmi from the
        precoding information (TM4: pinfo - 1), none for TM3."""
        from srslte_tpu_torch.phy.phch.pdsch import PdschSm, PdschSm4

        g0, g1 = dci.grants(100)
        if self.ports == 2:
            pmi = dci.pinfo - 1 if self.tm == 4 and dci.pinfo else None
            return PdschSm(self.cell, g0, SF_IDX, cfi=self.cfi, rnti=RNTI, pmi=pmi, grant1=g1)
        return PdschSm4(self.cell, g0, SF_IDX, cfi=self.cfi, rnti=RNTI, pmi=self.pmi4, grant1=g1)

    def grids(self, seed, batch=None):
        """batch (BATCH) subframes of the eNB's grids: ((bits0, bits1, ack),
        grids [B, ports, nsym, nre]); ack [B, ngroups, 8] in {-1: off, 0, 1}."""
        batch = batch or BATCH
        rng = np.random.default_rng(seed)
        dev = self.device
        tbs = self.pdsch.cfg.tbs
        bits = torch.as_tensor(rng.integers(0, 2, (2, batch, tbs), dtype=np.uint8), device=dev)
        ack = torch.as_tensor(rng.integers(-1, 2, (batch, self.phich.ngroups, 8)), device=dev)
        enb = self.enb
        g = enb.put_base(enb.empty_grids((batch,), device=dev), SF_IDX)
        g = enb.put_pcfich(g, SF_IDX, self.cfi)
        g = enb.put_phich(g, SF_IDX, ack)
        g = enb.put_pdcch(g, SF_IDX, self.cfi, self.dci_bits, RNTI, self.tx_loc)
        return (bits[0], bits[1], ack), self.pdsch.encode2(bits[0], bits[1], g)

    def encode(self, seed, batch=None):
        """((bits0, bits1, ack), rx [B, nrx, sf_len]): the grids through
        gen_signal and the channel matrix, before noise."""
        sent, g = self.grids(seed, batch)
        return sent, torch.einsum("rp,bps->brs", self.h, self.enb.gen_signal(g))

    def receive(self, rx, snr_db, gen, stages=None):
        """One dispatch of the UE side on a batch: AWGN (drawn anew from gen,
        none for snr_db None) -> UeDl.fft_estimate on every rx antenna ->
        Pcfich.decode, the PDCCH blind search and Phich.decode on rx 0 (the
        reference's control channels read one antenna) -> the DCI read back
        and the PDSCH rebuilt from it -> decode2 on every rx antenna with rx
        0's noise.  Returns a dict of device tensors and the DCI.  A
        subframe's DCI is right when one of its candidates carries the
        payload sent (as `Chain`; an L=8 DCI also decodes at L=4 on its first
        CCEs); a false hit is a candidate that passes its CRC with another
        payload."""
        def mark(name):
            if stages is not None:
                torch.cuda.synchronize()
                stages.append((name, time.perf_counter()))

        mark("start")
        rx = UlChain.noisy(rx, snr_db, gen)
        mark("awgn")
        grid, ce, info = self.ue.fft_estimate(rx, SF_IDX)  # [B, nrx, ...]
        mark("fft_estimate")
        g0, c0 = grid[:, 0], ce[:, 0]
        cfi, _ = self.pcfich.decode(g0, c0)
        mark("pcfich")
        ok, cand = self.pd._decode_mixed_traced(g0, c0, self.groups, self.dci_len, self.mask)
        # every candidate that passed its CRC, read back in one copy; the
        # DCI the most hits carry schedules the batch's PDSCH (a false hit,
        # a CRC16 passing on noise, is rare and carries another payload)
        both = torch.cat([ok[..., None].to(torch.uint8), cand], dim=-1).cpu().numpy()
        hits = both[..., 1:][both[..., 0] == 1]
        check(len(hits) > 0, "no DCI found in a dispatch")
        payloads, n = np.unique(hits, axis=0, return_counts=True)
        dci = self.unpack(payloads[np.argmax(n)], 100, self.ports)
        if dci not in self.scheduled:
            self.scheduled[dci] = self.pdsch_for(dci)
        pdsch = self.scheduled[dci]
        mark("pdcch_search")
        hi, _ = self.phich.decode(g0, c0)
        mark("phich")
        (b0, ok0), (b1, ok1) = pdsch.decode2(grid, ce, info["noise"][:, 0])
        mark("pdsch_decode2")
        right = ok & torch.all(cand == self.dci_bits_t, dim=-1)
        return {"bits": (b0, b1), "tb_ok": (ok0, ok1), "cfi_ok": cfi == self.cfi,
                "dci_ok": torch.any(right, dim=-1), "hi": hi, "dci": dci,
                "false_hits": ok & ~right}

    def decode(self, rx, snr_db, gen, siso_dtype=F32):
        """`receive` with the interface of `counted_dispatch`."""
        return self.receive(rx, snr_db, gen)


def sm_score(out, sent, label, dci=None):
    """(CFI right, DCI right, HI right share over the sent HIs, TB ok per
    codeword) of an SM dispatch; fails if the DCI read back is not the one
    sent or a TB that passed its CRC differs from the bits sent."""
    bits0, bits1, ack = sent
    check(dci is None or out["dci"] == dci, f"{label}: the DCI read back is {out['dci']}")
    on = ack >= 0
    hi_ok = int(((out["hi"] == (ack == 1)) & on).sum()) / int(on.sum())
    tb = []
    for q, bits in enumerate((bits0, bits1)):
        dec, ok = out["bits"][q], out["tb_ok"][q]
        check(dec.shape == bits.shape and dec.dtype == torch.uint8, f"{label}: TB shape or type")
        check(bool((dec[ok] == bits[ok]).all()),
              f"{label}: a TB of codeword {q} that passed CRC differs from the bits sent")
        tb.append(int(ok.sum()))
    return int(out["cfi_ok"].sum()), int(out["dci_ok"].sum()), hi_ok, tb


def sm_gates(score, n, label, noisy):
    """Clean: every CFI, DCI, HI and TB right.  Noisy: every CFI and DCI,
    HI >= 99 %, TB >= 80 % on each codeword."""
    cfi, dci, hi, tb = score
    check(cfi == n and dci == n, f"{label}: CFI {cfi}/{n}, DCI {dci}/{n}")
    if noisy:
        check(hi >= 0.99 and min(tb) >= 0.8 * n, f"{label}: HI {hi:.4f}, TB ok {tb} of {n}")
    else:
        check(hi == 1.0 and tb == [n, n], f"{label}: HI {hi:.4f}, TB ok {tb} of {n}")


def sm_hooks():
    """The stages of `SmChain.receive` for the sync count, as (owner,
    attribute, name)."""
    from srslte_tpu_torch.phy.phch.pcfich import Pcfich
    from srslte_tpu_torch.phy.phch.pdcch import Pdcch
    from srslte_tpu_torch.phy.phch.pdsch import PdschSm
    from srslte_tpu_torch.phy.phch.phich import Phich
    from srslte_tpu_torch.phy.ue.ue_dl import UeDl

    return ((UeDl, "fft_estimate", "fft_estimate"), (Pcfich, "decode", "pcfich"),
            (Pdcch, "_decode_mixed_traced", "pdcch_search"), (Phich, "decode", "phich"),
            (PdschSm, "decode2", "pdsch_decode2"))


def phase_sm(label, chain, snr_db, seed, timed_path=True, profile=False):
    """One SM deployment: a clean counted dispatch, a noisy counted dispatch
    at snr_db with its peak memory, then (timed_path) N_TIMED timed
    dispatches, one with a synchronise after each stage (and the 4-layer
    solve apart) and one with its host synchronisations counted.  Returns
    (the noisy dispatch's launch counts, the median ms or None, the
    stimulus)."""
    t0 = time.perf_counter()
    sent, rx = chain.encode(seed)
    torch.cuda.synchronize()
    check(rx.shape == (BATCH, chain.ports, 30720) and bool(torch.isfinite(
        torch.view_as_real(rx)).all()), f"{label}: stimulus shape or values")
    print(f"[{label}] stimulus: {BATCH} subframes encoded on the card in "
          f"{time.perf_counter() - t0:.1f} s; DCI {chain.dci_len} bits at {chain.tx_loc}, "
          f"{chain.n_cand} PDCCH candidates, {chain.phich.ngroups} PHICH groups", flush=True)
    out, counts, _ = counted_dispatch(chain, rx, None, None)
    score = sm_score(out, sent, label, chain.dci)
    sm_gates(score, BATCH, f"{label}, clean", noisy=False)
    print(f"[{label}, clean] {BATCH} subframes: every CFI = {chain.cfi}, DCI read back equal to "
          f"the one sent ({out['dci']}), every HI right, both TBs pass CRC and equal the bits "
          f"sent; launches {counts}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out, counts, mem = counted_dispatch(chain, rx, snr_db, gen)
    score = sm_score(out, sent, label, chain.dci)
    sm_gates(score, BATCH, f"{label}, {snr_db} dB", noisy=True)
    print(f"[{label}, {snr_db} dB] first dispatch: CFI {score[0]}/{BATCH}, DCI {score[1]}/{BATCH} "
          f"({int(out['false_hits'].sum())} false CRC hits among {BATCH * chain.n_cand} "
          f"candidates), "
          f"HI right {score[2]:.4f} of the sent ones, TB ok {score[3][0]}/{BATCH} and "
          f"{score[3][1]}/{BATCH}; kernel launches {counts}; peak device memory {mem[0]:.1f} MB, "
          f"{mem[1]:.1f} MB above what was allocated before it", flush=True)
    if not timed_path:
        return counts, None, (sent, rx)
    times, tb = [], list(score[3])
    for _ in range(N_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chain.receive(rx, snr_db, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        sc = sm_score(out, sent, label, chain.dci)
        check(sc[0] == BATCH and sc[1] == BATCH, f"{label}: CFI or DCI lost in a timed dispatch")
        tb = [a + b for a, b in zip(tb, sc[3])]
    ms = float(np.median(times))
    n = BATCH * (N_TIMED + 1)
    print(f"[{label}, {snr_db} dB] {N_TIMED} timed dispatches of {BATCH} subframes: "
          f"{[round(t, 3) for t in times]} ms, median {ms:.3f} ms/dispatch = "
          f"{BATCH / (ms * 1e-3):.1f} subframes/s ({BATCH / ms:.2f} x real time: {BATCH} "
          f"subframes are {BATCH} ms of air time); TB BLER per codeword over {n} TBs "
          f"{[round(1 - t / n, 4) for t in tb]}", flush=True)
    stages = []
    hooks = ((type(chain.pdsch), "soft_bits2", "mmse_demod"),)
    with eager(((type(chain.pdsch), "decode2"),)), stage_marks(stages, hooks):
        chain.receive(rx, snr_db, gen, stages=stages)
    stages.sort(key=lambda st: st[1])
    split = ", ".join(f"{nm} {(t - stages[i][1]) * 1e3:.2f}"
                      for i, (nm, t) in enumerate(stages[1:]))
    print(f"[{label}, {snr_db} dB] one more dispatch with a synchronise after each stage, ms "
          f"(decode2 eager, its __wrapped__; pdsch_decode2 after mmse_demod is the two "
          f"codewords' DL-SCH decode): {split}",
          flush=True)
    _, n_sync, per = count_syncs(lambda: chain.receive(rx, snr_db, gen), sm_hooks())
    print(f"[{label}, {snr_db} dB] host synchronisations (CUDA sync debug mode): {n_sync} in one "
          f"dispatch = {n_sync / BATCH:.3f} per subframe; by stage {per}", flush=True)
    if profile:
        phase_profile(label, lambda: chain.receive(rx, snr_db, gen), ms)
    return counts, ms, (sent, rx)


def phase_sm2(profile=False):
    """Phase 13, the slice's main path: the 2x2 SM DL at 20 MHz, TM4 (DCI 2)
    and TM3 (DCI 2A).  Returns the launch counts of each one's noisy counted
    dispatch, the TM4 median and the TM4 stimulus."""
    tm4 = SmChain(ports=2, tm=4)
    counts4, ms, stim = phase_sm("13 SM 2x2 TM4", tm4, SM_SNR_DB, SM_SEED, profile=profile)
    tm3 = SmChain(ports=2, tm=3)
    counts3, _, _ = phase_sm("13 SM 2x2 TM3", tm3, SM_SNR_DB, SM_SEED + 1, timed_path=False)
    return {"sm2_tm4": counts4, "sm2_tm3": counts3}, ms, (tm4, stim)


def phase_sm4(profile=False):
    """Phase 14: the 4-port cell at 20 MHz: PdschSm4 with pmi 0 (timed) and
    with CDD, 4-port PCFICH, PDCCH (DCI 2 at 54 bits) and PHICH on rx 0, and
    the 4-port PBCH of a subframe 0 read from a 4-port estimate."""
    from srslte_tpu_torch.phy.phch.pbch import Mib, Pbch

    c0 = SmChain(ports=4, pmi4=0)
    counts, ms, _ = phase_sm("14 SM 4x4 pmi 0", c0, SM4_SNR_DB, SM_SEED + 2, profile=profile)
    cdd = SmChain(ports=4, pmi4=None)
    phase_sm("14 SM 4x4 CDD", cdd, SM4_SNR_DB, SM_SEED + 3, timed_path=False)

    mib = Mib(n_prb=100, phich_length="norm", phich_resources="1", sfn=8)
    g = c0.enb.put_pbch(c0.enb.put_base(c0.enb.empty_grids((1,), device="cuda"), 0), mib)
    rx = torch.einsum("rp,bps->brs", c0.h, c0.enb.gen_signal(g))
    grid, ce, _ = c0.ue.fft_estimate(rx, 0)
    reset_counts()
    ok, bits, phase, ports = Pbch(c0.cell).decode(grid[0, 0], ce[0, 0])
    launches = read_counts()["viterbi_decode"]
    got = Mib.unpack(bits)
    check(ok and ports == 4 and phase == 0 and got == mib,
          f"4-port PBCH: ok {ok}, {ports} ports, phase {phase}, {got}")
    check(launches == 1, f"4-port PBCH: {launches} Viterbi launches")
    print(f"[14 SM 4x4] 4-port PBCH, subframe 0 through the 4x4 channel, decoded from rx 0's "
          f"4-port estimate: {got}, {ports} ports, frame phase {phase}; one Viterbi launch over "
          f"the 12 (phase x port) hypotheses", flush=True)
    return {"sm4": counts}, ms


def phase_dl_rest(sm):
    """Phase 15: the rest of the DL at 100 PRB, one call each on BATCH
    subframes: phase 13's noisy stimulus through the "interpolate" and
    "wiener" estimates, PMCH, the DwPTS PDSCH and the extended-duration
    PHICH.  Returns the launch counts of the PMCH and DwPTS paths."""
    import dataclasses

    from srslte_tpu_torch.phy.common.params import CP, Cell
    from srslte_tpu_torch.phy.common.tdd import TddConfig
    from srslte_tpu_torch.phy.ofdm import Ofdm
    from srslte_tpu_torch.phy.phch.pdsch import Pdsch
    from srslte_tpu_torch.phy.phch.pmch import Pmch
    from srslte_tpu_torch.phy.phch.ra import DlGrant
    from srslte_tpu_torch.phy.ue.ue_dl import UeDl

    tm4, (sent, rx) = sm
    gen = torch.Generator(device="cuda")
    # phase 13's noise draw at SM_SNR_DB (its first noisy dispatch), and the
    # same stimulus at the SNR where the JAX package's "interpolate" decodes
    # (see SM_INTERP_SNR_DB): there the reference loses codeword 1, so that
    # run gates codeword 0 only and prints codeword 1
    for alg, snr_db, gate_cw1 in (("interpolate", SM_SNR_DB, False),
                                  ("interpolate", SM_INTERP_SNR_DB, True),
                                  ("wiener", SM_SNR_DB, True)):
        chain = SmChain(ports=2, tm=4, chest=alg)
        _, first_ms, _ = timed(lambda: chain.receive(rx, None, None))  # tables built
        gen.manual_seed(SM_SEED)
        out, ms, peak = timed(lambda: chain.receive(rx, snr_db, gen))
        label = f"15 chest {alg}, {snr_db} dB"
        cfi, dci, hi, tb = sm_score(out, sent, label, chain.dci)
        sm_gates((cfi, dci, hi, tb if gate_cw1 else [tb[0], BATCH]), BATCH, label, noisy=True)
        print(f"[{label}] phase 13's TM4 stimulus through UeDl(chest_algorithm={alg!r}): CFI "
              f"{cfi}/{BATCH}, DCI {dci}/{BATCH}, HI {hi:.4f}, TB ok {tb} (codeword 1 "
              f"{'gated' if gate_cw1 else 'not gated: the JAX package decodes 0/16 here'}); "
              f"dispatch {ms:.3f} ms (the first, clean, with the tables built: {first_ms:.3f} "
              f"ms); peak device memory {peak}", flush=True)
    counts = {}

    # PMCH: mcs 20 over an extended-CP 100 PRB cell, area 1, subframe 3
    pm = Pmch(Cell(n_prb=100, id=1, cp=CP.EXT), area_id=1, sf_idx=3, mcs=20)
    rng = np.random.default_rng(SM_SEED + 4)
    bits = torch.as_tensor(rng.integers(0, 2, (BATCH, pm.cfg.tbs), dtype=np.uint8), device="cuda")
    o = pm.cell.ofdm
    ofdm = Ofdm(o, normalize=True)
    s = ofdm.tx_sf(pm.encode(bits, torch.zeros((BATCH, o.nsymb_sf, o.nof_re),
                                               dtype=torch.complex64, device="cuda")))
    (dec, ok), ms, _ = timed(lambda: pm.decode(ofdm.rx_sf(s)))
    check(bool(ok.all()) and bool((dec == bits).all()),
          f"PMCH clean: TB ok {int(ok.sum())}/{BATCH}, or the bits differ")
    gen.manual_seed(SM_SEED + 4)
    reset_counts()
    (dec, ok), ms20, peak = timed(lambda: pm.decode(ofdm.rx_sf(UlChain.noisy(s, 20.0, gen))))
    counts["pmch"] = read_counts()
    n_ok = int(ok.sum())
    check(n_ok >= 0.8 * BATCH and bool((dec[ok] == bits[ok]).all()),
          f"PMCH 20 dB: TB ok {n_ok}/{BATCH}, or a passing TB differs")
    bad = Pmch(pm.cell, area_id=2, sf_idx=3, mcs=20)
    _, ok_bad = bad.decode(ofdm.rx_sf(s))
    check(not bool(ok_bad.any()), f"PMCH area 2 on area 1's grid: {int(ok_bad.sum())} CRCs pass")
    print(f"[15 PMCH] mcs 20 (TBS {pm.cfg.tbs}, {pm.cfg.seg.C} code blocks of K "
          f"{pm.cfg.seg.K1}) on a 100 PRB extended-CP cell, {BATCH} subframes: clean every TB "
          f"({ms:.3f} ms); 20 dB TB ok {n_ok}/{BATCH} ({ms20:.3f} ms, peak device memory "
          f"{peak}); area 2 on the same grid: every CRC fails; launches {counts['pmch']}",
          flush=True)

    # DwPTS: the special subframe of TDD configuration 1 / special config 4
    tdd = TddConfig(sf_config=1, ss_config=4)
    cell = Cell(n_prb=100, id=1, nof_ports=1)
    grant = dataclasses.replace(DlGrant.full(100, 27), is_dwpts=True)
    p = Pdsch(cell, grant, sf_idx=1, cfi=CFI, rnti=RNTI, dwpts_symbols=tdd.nof_dw)
    rng = np.random.default_rng(SM_SEED + 5)
    bits = torch.as_tensor(rng.integers(0, 2, (BATCH, p.cfg.tbs), dtype=np.uint8), device="cuda")
    from srslte_tpu_torch.phy.enb.enb_dl import EnbDl

    enb = EnbDl(cell)
    g = enb.put_pdsch(enb.put_base(enb.empty_grids((BATCH,), device="cuda"), 1), p, bits)
    check(not bool(g[..., tdd.nof_dw:, :].abs().any()) and int(p.re_idx.max()) < tdd.nof_dw * 1200,
          "DwPTS: a PDSCH RE beyond the DwPTS symbols")
    ue = UeDl(cell)
    grid, ce, info = ue.fft_estimate(enb.gen_signal(g)[..., 0, :], 1)
    reset_counts()
    (dec, ok), ms, peak = timed(lambda: p.decode(grid, ce, info["noise"]))
    counts["dwpts"] = read_counts()
    check(bool(ok.all()) and bool((dec == bits).all()),
          f"DwPTS clean: TB ok {int(ok.sum())}/{BATCH}, or the bits differ")
    print(f"[15 DwPTS] TddConfig(1, 4): {tdd.nof_dw} DwPTS symbols, mcs 27 on TBS {p.cfg.tbs} "
          f"(75 PRB of TBS), G {p.cfg.G}, {p.cfg.seg.C} code blocks of K {p.cfg.seg.K1}; "
          f"{BATCH} clean subframes: every TB, no RE beyond symbol {tdd.nof_dw - 1}; decode "
          f"{ms:.3f} ms, peak device memory {peak}; launches {counts['dwpts']}", flush=True)

    # extended-duration PHICH at CFI 3 on the 2x2 cell
    ext = SmChain(ports=2, tm=4, cfi=3, phich_length="ext")
    (_, _, ack), g = ext.grids(SM_SEED + 6)
    rx = torch.einsum("rp,bps->brs", ext.h, ext.enb.gen_signal(g))
    grid, ce, _ = ext.ue.fft_estimate(rx, SF_IDX)
    cfi, _ = ext.pcfich.decode(grid[:, 0], ce[:, 0])
    hi, _ = ext.phich.decode(grid[:, 0], ce[:, 0])
    on = ack >= 0
    check(bool((cfi == 3).all()) and bool(((hi == (ack == 1)) | ~on).all()),
          "extended-duration PHICH: a CFI or HI wrong on a clean channel")
    print(f"[15 PHICH ext] CFI 3, extended duration, {ext.phich.ngroups} groups over symbols "
          f"0-2, {BATCH} clean subframes through the 2x2 channel: every CFI and every sent HI "
          f"right", flush=True)
    return counts


# ------------------------------------------------------- channel emulator
def median_ms(fn, n=N_TIMED):
    """(the median host ms of n calls of fn, each ending in a synchronise,
    the last call's result)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def channel_score(out, bits, label, subframes=None):
    """(CFI, DCI, TB ok, false CRC hits) of a `Chain.receive` over the
    subframes selected by the bool mask `subframes` (all when None); fails
    if a TB that passed its CRC differs from the bits sent."""
    sel = torch.ones_like(out["tb_ok"]) if subframes is None else subframes
    ok = out["tb_ok"] & sel
    check(bool((out["bits"][ok] == bits[ok]).all()),
          f"{label}: a TB that passed CRC differs from the bits sent")
    return tuple(int((v & sel).sum()) for v in (out["cfi_ok"], out["dci_ok"], out["tb_ok"])) + (
        int(out["false_hits"][sel].sum()),)


def channel_gates(clean, noisy, n, label, jax_clean):
    """Clean (faded, no noise): CFI, DCI and TB at least the JAX package's
    counts on the same subframes.  Noisy: TB ok >= 80 %, no false CRC hit
    (a candidate passing its CRC with another payload)."""
    check(all(a >= b for a, b in zip(clean[:3], jax_clean)) and clean[3] == 0,
          f"{label} clean: CFI, DCI, TB {clean[:3]} of {n} (the JAX package: {jax_clean}), "
          f"{clean[3]} false CRC hits")
    check(noisy[2] >= 0.8 * n and noisy[3] == 0,
          f"{label}: TB ok {noisy[2]}/{n} (80 % required), {noisy[3]} false CRC hits")


def phase_channel(profile=False):
    """Phase 16, the slice's main path: each fading profile of CHANNELS on
    its own 128-subframe stream: the channel clean (counted), at the
    profile's SNR (counted; for EVA70 also in 16 bits on the same noise),
    timed, and (EPA5) with a delay and RLF bursts.  Returns the launch
    counts of each profile's noisy counted dispatch."""
    from srslte_tpu_torch.phy.channel import (FadingChannel, awgn, fractional_delay,
                                              rlf_mask)

    counts = {}
    for name, (prof, fd, mcs, est, snr_db) in CHANNELS.items():
        label = f"16 channel {name}"
        chain = Chain(mcs=mcs, chest=est)
        bits, s = chain.encode(CHANNEL_SEED)
        ch = FadingChannel(prof, fd, CHANNEL_SRATE, seed=FADING_SEED)
        stream = s.reshape(-1)
        _, first_ms, _ = timed(lambda: ch(stream))  # tables built and uploaded
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        ch_ms, faded = median_ms(lambda: ch(stream))
        faded = faded.reshape(BATCH, -1)
        check(faded.shape == s.shape and bool(torch.isfinite(torch.view_as_real(faded)).all()),
              f"{label}: faded stream shape or values")
        gain = float(torch.mean(torch.abs(faded) ** 2) / torch.mean(torch.abs(s) ** 2))
        msps = stream.numel() / (ch_ms * 1e-3) / 1e6
        print(f"[{label}] {prof.upper()} {fd:g} Hz ({ch.nfft}-point blocks of {ch.block}, halo "
              f"{ch.halo}) on {stream.numel()} samples: {ch_ms:.3f} ms (median of {N_TIMED}; first "
              f"call {first_ms:.3f} ms) = {msps:.1f} Msamples/s ({msps / REALTIME_MSPS:.1f} x real "
              f"time at 30.72); power through the channel x {gain:.3f}", flush=True)

        out, _, _ = counted(lambda: chain.receive(faded))
        clean = channel_score(out, bits, label)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(CHANNEL_SEED)
        rx = awgn(gen, faded, snr_db)
        out, counts[f"channel_{name}"], _ = counted(lambda: chain.receive(rx))
        noisy = channel_score(out, bits, label)
        channel_gates(clean, noisy, BATCH, label, CHANNEL_JAX_CLEAN[name])
        extra = ""
        if name == "eva70":
            out16, c16, _ = counted(lambda: chain.receive(rx, siso_dtype=BF16), BF16)
            n16 = channel_score(out16, bits, label + " 16-bit")
            check(n16[2] >= 0.8 * BATCH and n16[3] == 0, f"{label} 16-bit: TB ok {n16[2]}")
            counts["channel_eva70"]["siso_windowed_bf16"] = c16["siso_windowed_bf16"]
            extra = f"; the same noise with the SISO in 16 bits: TB ok {n16[2]}, launches {c16}"
        print(f"[{label}] mcs {mcs}, {est!r} estimate: clean CFI {clean[0]}, DCI {clean[1]}, TB "
              f"{clean[2]} of {BATCH} (the JAX package: {CHANNEL_JAX_CLEAN[name]}); {snr_db} dB: "
              f"CFI {noisy[0]}, DCI {noisy[1]}, TB ok {noisy[2]}/{BATCH}, false CRC hits {noisy[3]}; "
              f"launches {counts[f'channel_{name}']}{extra}", flush=True)

        def dispatch():
            return chain.receive(awgn(gen, ch(stream).reshape(BATCH, -1), snr_db))

        dec_ms, _ = median_ms(lambda: chain.receive(awgn(gen, faded, snr_db)))
        all_ms, _ = median_ms(dispatch)
        peak = torch.cuda.max_memory_allocated()
        print(f"[{label}] {N_TIMED} timed dispatches of {BATCH} subframes: AWGN + decode "
              f"{dec_ms:.3f} ms, channel + AWGN + decode {all_ms:.3f} ms "
              f"({BATCH / all_ms:.2f} x real time); peak device memory {peak / 1e6:.1f} MB, "
              f"{(peak - before) / 1e6:.1f} MB above the start of the timed channel calls",
              flush=True)
        if profile and name == "eva70":
            phase_profile("channel EVA70", dispatch, all_ms)

        if name == "etu300":
            for alg in ETU_REPORTED:
                other = Chain(mcs=mcs, chest=alg)
                sc = [channel_score(other.receive(r), bits, f"{label} {alg}")
                      for r in (faded, awgn(gen, faded, snr_db))]
                print(f"[{label}] the same stream through UeDl(chest_algorithm={alg!r}) "
                      f"(reported): clean CFI, DCI, TB {sc[0][:3]}; {snr_db} dB {sc[1][:3]}, false "
                      f"CRC hits {sc[0][3]} + {sc[1][3]}", flush=True)

        if name == "epa5":
            mask = rlf_mask(stream.numel(), CHANNEL_SRATE, RLF_ON_MS, RLF_OFF_MS, device="cuda")
            x = (fractional_delay(faded.reshape(-1), CHANNEL_DELAY) * mask).reshape(BATCH, -1)
            on = mask.reshape(BATCH, -1).bool().all(dim=-1)
            off = ~mask.reshape(BATCH, -1).bool().any(dim=-1)
            out, _, _ = counted(lambda: chain.receive(awgn(gen, x, snr_db)))
            son = channel_score(out, bits, label + " RLF", on)
            soff = channel_score(out, bits, label + " RLF", off)
            n_on = int(on.sum())
            check(son[2] >= 0.8 * n_on and son[3] == 0,
                  f"{label} RLF: on-subframes TB ok {son[2]}/{n_on}, {son[3]} false CRC hits")
            check(soff[1] == 0 and soff[2] == 0 and soff[3] == 0,
                  f"{label} RLF: off-subframes DCI {soff[1]}, TB {soff[2]}, CRC hits {soff[3]}")
            print(f"[{label}] delay {CHANNEL_DELAY} samples, RLF {RLF_ON_MS:g} ms on / "
                  f"{RLF_OFF_MS:g} ms off, {snr_db} dB: {n_on} on-subframes TB ok {son[2]}, false "
                  f"CRC hits {son[3]}; {int(off.sum())} subframes wholly inside an off burst: DCI "
                  f"{soff[1]}, TB {soff[2]}, CRC hits {soff[3]}", flush=True)
        del s, faded, rx, stream
    return counts


# ----------------------------------------------------------------- rails
def pipe_loopback(x, sf_len):
    """x [n] (numpy, cell rate) through a PipeRadio at the ZMQ base rate, one
    subframe per tx / rx_now.  Each burst read back must equal the resample
    round trip made on the card; one that does not arrive whole is sent
    again on a fresh port, at most PIPE_TRIES times in all.  Returns (the
    samples read back, ms per burst, tries)."""
    from srslte_tpu_torch.phy.resampling import resample_fft
    from srslte_tpu_torch.radio import PipeRadio

    out, times, port, tries = [], [], PIPE_PORT, 0
    radio = PipeRadio(rx_port=port, tx_port=port, base_srate=ZMQ_BASE_SRATE,
                      cell_srate=CHANNEL_SRATE)
    try:
        for sf in x.reshape(-1, sf_len):
            want = resample_fft(resample_fft(torch.as_tensor(sf).cuda(), 3, 4), 4, 3).cpu().numpy()
            for _ in range(PIPE_TRIES):
                tries += 1
                t0 = time.perf_counter()
                radio.tx(sf)
                y, _ = radio.rx_now(sf_len)
                times.append((time.perf_counter() - t0) * 1e3)
                if np.array_equal(y, want):
                    break
                radio.close()
                port += 1
                radio = PipeRadio(rx_port=port, tx_port=port, base_srate=ZMQ_BASE_SRATE,
                                  cell_srate=CHANNEL_SRATE)
            check(np.array_equal(y, want), f"pipe radio: a burst did not arrive whole in "
                                           f"{PIPE_TRIES} tries")
            out.append(y)
    finally:
        radio.close()
    return np.concatenate(out), float(np.median(times)), tries


def tone_evm(y, f):
    """EVM of y against a tone of f cycles per sample after one complex gain,
    ARB_GUARD samples at each end left out (tests/test_channel_io.py:212-230)."""
    ref = np.exp(2j * np.pi * f * np.arange(len(y)))
    core_y, core_r = y[ARB_GUARD:-ARB_GUARD], ref[ARB_GUARD:-ARB_GUARD]
    g = np.vdot(core_r, core_y) / np.vdot(core_r, core_r)
    return float(np.linalg.norm(core_y - g * core_r) / np.linalg.norm(core_y))


def rails_stream(a, sf_len, hst):
    """Stream a (numpy, cell rate) through the train (when `hst`) and the
    delay on the card, the file radio and the pipe radio, -30 dB and the
    AGC.  Returns (the AGC's output on the card, a line of what was
    measured)."""
    from srslte_tpu_torch.phy.agc import Agc
    from srslte_tpu_torch.phy.channel import fractional_delay
    from srslte_tpu_torch.phy.channel.hst import apply_hst
    from srslte_tpu_torch.radio import FileRadio

    n = len(a)
    x = torch.as_tensor(a).cuda()
    msg = ""
    if hst:
        hst_ms, xh = median_ms(lambda: apply_hst(x, CHANNEL_SRATE, t0=HST_T0, **HST))
        check(float((xh.abs() - x.abs()).abs().max()) < 1e-5, "HST changed the amplitude")
        x, msg = xh, f"apply_hst {hst_ms:.3f} ms, "
    del_ms, xd = median_ms(lambda: fractional_delay(x, HST_DELAY))
    xd = xd.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.bin")
        t0 = time.perf_counter()
        radio = FileRadio(tx_path=path, srate=CHANNEL_SRATE)
        radio.tx(xd)
        radio.close()
        radio = FileRadio(rx_path=path, srate=CHANNEL_SRATE)
        back, ts = radio.rx_now(n)
        radio.close()
        file_ms = (time.perf_counter() - t0) * 1e3
    check(ts.sample_count == 0 and np.array_equal(back, xd), "file radio: samples read back differ")
    piped, burst_ms, tries = pipe_loopback(back, sf_len)
    scaled = torch.as_tensor(piped).cuda() * float(10 ** (AGC_SCALE_DB / 20))
    agc = Agc(target=AGC_TARGET)
    agc_ms, (y, gains, _) = median_ms(lambda: agc.process(scaled, sf_len))
    rms = float(torch.sqrt(torch.mean(torch.abs(y[-4 * sf_len:]) ** 2)))
    check(abs(rms - AGC_TARGET) / AGC_TARGET < 0.15,
          f"AGC: RMS of the last 4 frames {rms} against the target {AGC_TARGET}")
    msg += (f"fractional_delay {HST_DELAY} samples {del_ms:.3f} ms (medians of {N_TIMED}); "
            f"FileRadio tx + rx_now: every sample read back equal ({file_ms:.1f} ms); PipeRadio "
            f"at {ZMQ_BASE_SRATE / 1e6:g} Msps over the UDP pipe, {n // sf_len} bursts of "
            f"{sf_len * 3 // 4} base samples: every burst equal to the resample round trip "
            f"({tries} sends), tx + rx_now {burst_ms:.3f} ms per burst (median); "
            f"{AGC_SCALE_DB:g} dB, then Agc(target={AGC_TARGET}).process, frames of {sf_len}: RMS "
            f"of the last 4 frames {rms:.4f} (within 15 % required), gain "
            f"{float(gains[0, 0]):.2f} -> {float(gains[0, -1]):.2f} dB, {agc_ms:.3f} ms per call")
    return y, msg


def phase_rails(capture, profile=False):
    """Phase 17: phase 12's stream A through the rails (`rails_stream`) with
    and without the high-speed train, each then through the blind receiver;
    the neighbour measurement and the arbitrary-rate resampler.  Returns the
    kernel launch counts of the two blind receives."""
    from srslte_tpu_torch.phy.channel import awgn
    from srslte_tpu_torch.phy.channel.hst import hst_doppler
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.phy.enb.enb_dl import EnbDl
    from srslte_tpu_torch.phy.resampling import resample_arb
    from srslte_tpu_torch.phy.resampling.resampler import _arb_plan
    from srslte_tpu_torch.phy.ue.intra_measure import IntraMeasure

    a, bits, cell, dci, _ = capture
    sf_len = cell.ofdm.sf_len
    f = hst_doppler(HST_T0 + np.array([0.0, len(a) / CHANNEL_SRATE]), **HST)
    check(f[0] > 0 > f[1], f"HST: the Doppler's sign flip is not inside the stream ({f})")
    print(f"[17 rails] the train: 36.101 B.3 scenario 3 (f_d {HST['f_d']:g} Hz, ds "
          f"{HST['ds']:g} m, d_min {HST['d_min']:g} m, {HST['v']:g} km/h) from t0 {HST_T0} s: "
          f"Doppler {f[0]:.1f} Hz at the start of stream A, {f[1]:.1f} Hz at its end", flush=True)
    reset_counts()
    for name, hst in (("rails", False), ("rails_hst", True)):
        y, msg = rails_stream(a, sf_len, hst)
        print(f"[17 {name}] {msg}", flush=True)
        out, rx_ms, peak = timed(lambda: blind_receive(y))
        n_sf, cfi, ok, crc = blind_score(out, cell, dci, bits, name, dci_in_every=False)
        n_dci = sum(r["dci"] == dci for r in out["results"])
        want_dci, want_tb = RAILS_JAX[name]
        check(cfi == n_sf and n_dci >= want_dci and ok >= want_tb,
              f"{name}: CFI {cfi}, DCI {n_dci}, TB ok {ok} of {n_sf} (CRC {crc}; the JAX "
              f"receiver: DCI {want_dci}, TB {want_tb})")
        print(f"[17 {name}] blind receive: cell {out['cell'].id}, {out['mib']}; {n_sf} subframes: "
              f"CFI {cfi}/{n_sf}, DCI {n_dci}/{n_sf}, TB ok {ok}/{n_sf} (the JAX receiver's DCI "
              f"{want_dci} and TB {want_tb} required), CRC per subframe {crc}; receive "
              f"{rx_ms:.3f} ms, peak device memory {peak}", flush=True)
        if not hst:
            plain = (y, rx_ms)
    counts = read_counts()
    for name in ("siso_windowed", "viterbi_decode"):
        check(counts[name] > 0, f"the rails' blind receives did not launch the {name} kernel")
    print(f"[17 rails] kernel launches of the two blind receives {counts}", flush=True)
    if profile:
        phase_profile("rails blind receive", lambda: blind_receive(plain[0]), plain[1])

    # neighbour measurement: cell 1 at 0 dB, cell 111 at -10 dB, PCI 300
    # absent, 10 captures of subframe 2 with noise 10 dB below their power
    sf_idx, gen = 2, torch.Generator(device="cuda")
    gen.manual_seed(17)
    x = 0
    for pci, gain in ((1, 1.0), (111, 10 ** (-10 / 20))):
        enb = EnbDl(Cell(n_prb=100, id=pci, nof_ports=1))
        x = x + gain * enb.gen_signal(enb.put_base(enb.empty_grids((10,), device="cuda"),
                                                   sf_idx))[:, 0]
    x = awgn(gen, x, 10.0)
    im = IntraMeasure(100, (1, 111, 300))
    im_ms, m = median_ms(lambda: im.measure(x, sf_idx))
    rsrp, rsrq = m["rsrp"], m["rsrq"]
    check(bool((rsrp[0] > 5 * rsrp[1]).all() and (5 * rsrp[1] > 5 * rsrp[2]).all()
               and (rsrq[0] > rsrq[1]).all()),
          f"IntraMeasure ranking: rsrp {rsrp.mean(-1).tolist()}, rsrq {rsrq.mean(-1).tolist()}")
    print(f"[17 rails] IntraMeasure(100, (1, 111, 300)) on 10 subframes: RSRP (mean) "
          f"{[round(v, 5) for v in rsrp.mean(-1).tolist()]}, RSRQ "
          f"{[round(v, 3) for v in rsrq.mean(-1).tolist()]}: rsrp[0] > 5 rsrp[1] > 5 rsrp[2] and "
          f"rsrq[0] > rsrq[1] in every subframe; {im_ms:.3f} ms per call (median)", flush=True)

    # the arbitrary-rate resampler on one frame of a tone, at the ZMQ ratio
    # and at the rate of tests/test_channel_io.py's tone test
    nf = 10 * sf_len
    tone = torch.as_tensor(np.exp(2j * np.pi * ARB_TONE * np.arange(nf)).astype(np.complex64))
    tone = tone.cuda()
    for rate, evm_max in ((ARB_RATE, ARB_JAX_EVM * 1.001), (ARB_TEST_RATE, 0.02)):
        t0 = time.perf_counter()
        _arb_plan(nf, float(rate), True)
        plan_ms = (time.perf_counter() - t0) * 1e3
        _, first_ms, _ = timed(lambda: resample_arb(tone, rate, interpolate=True))
        arb_ms, yr = median_ms(lambda: resample_arb(tone, rate, interpolate=True))
        evm = tone_evm(yr.cpu().numpy(), ARB_TONE / rate)
        check(evm < evm_max, f"resample_arb rate {rate}: tone EVM {evm} (limit {evm_max})")
        print(f"[17 rails] resample_arb rate {rate:.6g} on one frame ({nf} -> {yr.numel()} "
              f"samples): plan {plan_ms:.1f} ms on the host (then the first call, with the upload, "
              f"{first_ms:.1f} ms), {arb_ms:.3f} ms per call (median); tone EVM {evm:.5f} (below "
              f"{evm_max:.5g} required)", flush=True)
    return counts


# ------------------------------------------------------------ the full stack
def stack_port(device="cuda"):
    """The port's full-stack entry points, for `stack_scenario`, on `device`."""
    from srslte_tpu_torch import enb, ue, ue_stack
    from srslte_tpu_torch.epc import Hss, Mme, Spgw
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.phy.phch import pdsch
    from srslte_tpu_torch.security.milenage import compute_opc

    return types.SimpleNamespace(
        EnbApp=functools.partial(enb.EnbApp, device=device),
        UeApp=functools.partial(ue.UeApp, device=device), UeNas=ue_stack.UeNas,
        SoftUsim=ue_stack.SoftUsim, Hss=Hss, Mme=Mme, Spgw=Spgw, Cell=Cell,
        compute_opc=compute_opc, Pdsch=pdsch.Pdsch,
        crc_fail=lambda ok: torch.zeros_like(torch.as_tensor(ok), dtype=torch.bool))


def stack_packets(n, seed):
    """n packets of STACK_BULK_BYTES seeded bytes."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, STACK_BULK_BYTES, dtype=np.uint8).tobytes() for _ in range(n)]


def stack_scenario(name, pkg, call=None, bulk_hooks=None):
    """Scenario `name` (A-D, see STACK_PRB) of phase 18 on the package
    `pkg` (`stack_port`, or the JAX package's classes in
    tests/rehearse_stack.py).  call(label, fn, *args) makes each of the four
    per-TTI calls (default: a plain call); bulk_hooks (start, stop) are
    called when scenario A queues its bulk and when the bulk has all
    arrived.  Returns (the first TTI at which
    each state was reached, the TTIs run, the gates as {name: bool}, counts
    for the report)."""
    call = call or (lambda label, fn, *args: fn(*args))
    subs = STACK_SUBSCRIBERS[: 2 if name == "B" else 1]
    cell = pkg.Cell(n_prb=STACK_PRB, id=STACK_CELL_ID, nof_ports=1)
    hss = pkg.Hss()
    for imsi, k in subs:
        hss.add_subscriber(imsi, k, op=STACK_OP)
    mme = pkg.Mme(hss, pkg.Spgw())
    enb = pkg.EnbApp(cell, mme=mme)
    ues = [pkg.UeApp(cell, pkg.UeNas(pkg.SoftUsim(imsi, k, pkg.compute_opc(k, STACK_OP))))
           for imsi, k in subs]
    starts = (0, STACK_UE2_START)
    cc = enb.ccs[cell.id]
    first = {}
    sent = [None] * len(ues)  # (UL packets, DL packets) once queued
    counts = {"nack_armed": 0, "retx_queued": 0, "queued_tti": None}
    corrupt = {"on": False}
    state = {"released": False, "paged": False, "old_crnti": 0}
    real_decode = pkg.Pdsch.decode

    def flaky_decode(self, grid, ce, noise, **kw):
        bits, ok = real_decode(self, grid, ce, noise, **kw)
        return (bits, pkg.crc_fail(ok)) if corrupt["on"] else (bits, ok)

    def mark(event, cond, tti):
        if cond and event not in first:
            first[event] = tti

    def ctx(ue):
        return enb.ues.get(ue.crnti) if ue.crnti else None

    if name == "C":
        pkg.Pdsch.decode = flaky_decode
    try:
        for tti in range(STACK_MAX_TTI[name]):
            dl = call("enb.tx_subframe", enb.tx_subframe, tti)
            uls = []
            for i, ue in enumerate(ues):
                if tti < starts[i]:
                    continue
                call("ue.rx_subframe", ue.rx_subframe, dl, tti)
                if ue.pending_ack.get(tti + 4, (None, None))[1] == 0:
                    counts["nack_armed"] += 1
                ul = call("ue.tx_subframe", ue.tx_subframe, tti)
                if ul is not None:
                    uls.append(ul)
            ul = uls[0] + uls[1] if len(uls) == 2 else (uls[0] if uls else None)
            call("enb.rx_subframe", enb.rx_subframe, ul, tti)
            counts["retx_queued"] += len(cc.dl_retx)
            for i, ue in enumerate(ues):
                sfx = f"_{i + 1}" if len(ues) > 1 else ""
                c = ctx(ue)
                for event, cond in (("mib", ue.mib is not None), ("sib1", ue.sib1 is not None),
                                    ("sib2", ue.sib2 is not None),
                                    ("rach_sent", ue.state == "rach_sent"),
                                    ("ra_done", ue.state == "connected"),
                                    ("rrc_connected", c is not None
                                     and c.rrc_state == "connected"),
                                    ("nas_attached", ue.nas.state == "attached"),
                                    ("drb", ue.pdcp_drb is not None),
                                    ("rrc_reconfigured", c is not None
                                     and c.rrc_state == "rrc_reconfigured")):
                    mark(event + sfx, cond, tti)
                if (name != "D" and ue.nas.state == "attached" and ue.pdcp_drb is not None
                        and sent[i] is None):
                    if name == "A":
                        sent[i] = (stack_packets(STACK_BULK, STACK_SEED),
                                   stack_packets(STACK_BULK, STACK_SEED + 1))
                        counts["queued_tti"] = tti
                        if bulk_hooks:
                            bulk_hooks[0]()
                    elif name == "B":
                        sent[i] = ([f"ul-ping-{i + 1}".encode()], [f"dl-pong-{i + 1}".encode()])
                    else:
                        sent[i] = ([], [b"harq-payload"])
                        corrupt["on"] = True  # the next DL data TB fails its CRC
                    for p in sent[i][0]:
                        ue.send_data(p)
                    for p in sent[i][1]:
                        enb.send_data(ue.crnti, p)
                if sent[i] is not None:
                    got_ul = c.rx_data if c is not None else []
                    mark("dl_first" + sfx, len(ue.rx_data) > 0, tti)
                    mark("dl_all" + sfx, len(ue.rx_data) >= len(sent[i][1]), tti)
                    if sent[i][0]:
                        mark("ul_first" + sfx, len(got_ul) > 0, tti)
                        mark("ul_all" + sfx, len(got_ul) >= len(sent[i][0]), tti)
            if name == "C":
                mark("nack", counts["nack_armed"] > 0, tti)
                mark("retx", counts["retx_queued"] > 0, tti)
                if "nack" in first:
                    corrupt["on"] = False  # one NACK is enough: let the retx decode
            if name == "D":
                ue = ues[0]
                c = ctx(ue)
                if (ue.nas.state == "attached" and not state["released"] and c is not None
                        and c.rrc_state in ("secure", "rrc_reconfigured")):
                    enb.release_connection(c)
                    state.update(released=True, old_crnti=ue.crnti)
                    mark("release_sent", True, tti)
                if state["released"] and ue.state == "camped" and not state["paged"]:
                    enb.release_ue(enb.ues[state["old_crnti"]])
                    enb.page(ue.nas.guti)
                    state["paged"] = True
                    mark("camped", True, tti)
                mark("paged", ue.paged > 0, tti)
                if state["paged"] and ue.paged and ue.state == "connected":
                    mark("reconnected", True, tti)
                    break
            elif all(s is not None for s in sent) and all(
                    f"{d}_all{f'_{i + 1}' if len(ues) > 1 else ''}" in first
                    for i in range(len(ues)) for d, n in (("dl", 1), ("ul", 0)) if sent[i][n]):
                if name == "A" and bulk_hooks:
                    bulk_hooks[1]()
                break
    finally:
        pkg.Pdsch.decode = real_decode
    return first, tti + 1, stack_gates(name, ues, enb, mme, sent, counts), counts


def stack_gates(name, ues, enb, mme, sent, counts):
    """The gates of a phase 18 scenario: the reference's full-stack
    assertions, and every packet delivered once, in order, to its own UE."""
    g = {}
    for i, ue in enumerate(ues):
        sfx = f"_{i + 1}" if len(ues) > 1 else ""
        c = enb.ues.get(ue.crnti) if ue.crnti else None
        g["mib_sib1_sib2" + sfx] = (ue.mib is not None and ue.sib1 is not None
                                    and ue.sib2 is not None)
        g["connected" + sfx] = ue.state == "connected"
        if name == "D":  # reconnected: its NAS attaches anew over the new connection
            continue
        g["attached" + sfx] = ue.nas.state == "attached" and str(ue.nas.ip).startswith(
            "172.16.0.")
        g["nas_keys" + sfx] = (c is not None
                               and ue.nas.sec.k_int == mme.ues[c.ue_id].sec.k_int)
        if sent[i] is not None:
            g["dl_in_order" + sfx] = ue.rx_data == sent[i][1]
            g["ul_in_order" + sfx] = c is not None and c.rx_data == sent[i][0]
        else:
            g["data_queued" + sfx] = False
    if name == "B":
        g["distinct_crnti"] = ues[0].crnti != ues[1].crnti
    if name == "A":
        g["no_nack_no_retx"] = counts["nack_armed"] == 0 and counts["retx_queued"] == 0
    if name == "C":
        g["nack_and_retx"] = counts["nack_armed"] > 0 and counts["retx_queued"] > 0
    if name == "D":
        g["paged_and_reconnected"] = bool(ues[0].paged >= 1 and ues[0].crnti
                                          and ues[0].crnti in enb.ues)
    return g


def stack_timer(times, tti_end):
    """call(label, fn, *args) for `stack_scenario` (and phase 21's
    scenarios) on the card: each call
    synchronised and timed on the host clock (ms into times[label]); the
    host time at the end of each TTI (its last call, EnbApp.rx_subframe)
    into tti_end."""
    def call(label, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.setdefault(label, []).append((t1 - t0) * 1e3)
        if label == "enb.rx_subframe":
            tti_end.append(t1)
        return out
    return call


@contextlib.contextmanager
def launch_shapes(by_shape, kernels=None):
    """While open, every kernel launch (the launches a replayed CUDA graph
    captured included) adds one to by_shape[(kernel, shape)]; `kernels`
    keeps only those kernels."""
    from srslte_tpu_torch.ops import tdec_cuda, viterbi_cuda
    from srslte_tpu_torch.utils import jit

    owners = (tdec_cuda.siso_windowed, viterbi_cuda.viterbi_decode)
    jit.fold_launches()
    before = [collections.Counter(o.shapes) for o in owners]
    try:
        yield by_shape
    finally:
        jit.fold_launches()
        for o, b in zip(owners, before):
            by_shape.update({k: n for k, n in (o.shapes - b).items()
                             if kernels is None or k[0] in kernels})


def table_cache():
    """(entries, MB) of the port's shared device tables, then of its per-UE
    sequences (`_device.sequence`, bounded)."""
    from srslte_tpu_torch import _device

    def size(d):
        return len(d), sum(t.numel() * t.element_size() for t in d.values()) / 1e6
    return size(_device._TABLES) + size(_device._SEQUENCES)


def phase_stack(smi, profile=False):
    """The full stack at 20 MHz (see STACK_PRB): scenarios A-D through
    EnbApp and UeApp on the card, gated on the reference's assertions, on
    every packet delivered once and in order to its own UE, and on the TTI
    at which each state is first reached equalling the JAX package's
    (STACK_JAX).  Scenario A is the stack path's counted run.  Returns its
    kernel launch counts."""
    from srslte_tpu_torch.utils import jit

    pkg = stack_port()
    counts_a, n_graphs = None, {}
    for name in "ABCD":
        times, tti_end, by_shape = {}, [], collections.Counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        prof = None
        if name == "A":
            reset_counts()
            if profile:
                from torch.profiler import ProfilerActivity
                prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                          ProfilerActivity.CUDA])
        bulk = {}
        t0 = time.perf_counter()
        with launch_shapes(by_shape):
            if name == "C":  # untimed: its host synchronisations are counted
                (first, ttis, gates, counts), n_sync, _ = count_syncs(
                    lambda: stack_scenario(name, pkg), ())
            else:
                first, ttis, gates, counts = stack_scenario(
                    name, pkg, stack_timer(times, tti_end),
                    bulk_hooks=None if prof is None else (
                        lambda: (prof.start(), bulk.update(t0=time.perf_counter())),
                        lambda: (torch.cuda.synchronize(), bulk.update(t1=time.perf_counter()),
                                 prof.stop())))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "A":
            counts_a = read_counts()
            for k in ("siso_windowed", "viterbi_decode"):
                check(counts_a[k] > 0, f"the full stack did not launch the {k} kernel")
            short = sum(n for (k, shp), n in by_shape.items()
                        if k == "siso_windowed" and shp.endswith(" T=0"))
            check(short > 0, "no code block of K < 256 went through the SISO kernel")
        peak = torch.cuda.max_memory_allocated()
        n_tab, mb_tab, n_seq, mb_seq = table_cache()
        n_graphs[name] = jit.graphs()
        if name == "C":
            keys_c = set(jit.keys())
        failed = [g for g, ok in gates.items() if not ok]
        check(not failed, f"full stack, scenario {name}: gates failed: {failed}")
        want = STACK_JAX[name]
        diff = {k: (first.get(k), want.get(k)) for k in set(first) | set(want)
                if first.get(k) != want.get(k)}
        check(not diff, f"full stack, scenario {name}: first TTI per state differs from the "
                        f"JAX package's (port, JAX): {diff}")
        print(f"[18 full stack, {name}] {ttis} TTIs in {wall:.2f} s of wall time; every gate "
              f"passed ({', '.join(gates)}); first TTI per state {first}, equal to the JAX "
              f"package's; counts {counts}", flush=True)
        print(f"[18 full stack, {name}] peak device memory {peak / 1e6:.1f} MB "
              f"({(peak - before) / 1e6:.1f} MB above what was allocated before); table cache "
              f"{n_tab} shared entries, {mb_tab:.2f} MB, {n_seq} per-UE sequences, "
              f"{mb_seq:.2f} MB; CUDA graphs in the cache {n_graphs[name]['count']} "
              f"({n_graphs[name]['mb']:.1f} MB); {smi}", flush=True)
        for label, ms in times.items():
            print(f"[18 full stack, {name}] {label}: {len(ms)} calls, ms median "
                  f"{float(np.median(ms)):.3f}, p99 {float(np.percentile(ms, 99)):.3f}, "
                  f"max {max(ms):.3f} (LTE's TTI: 1 ms)", flush=True)
        if name == "C":
            print(f"[18 full stack, C] host synchronisations (CUDA sync debug mode): {n_sync} in "
                  f"{ttis} TTIs = {n_sync / ttis:.2f} per TTI", flush=True)
        if "nas_attached" in first and tti_end:
            print(f"[18 full stack, {name}] attach: {first['nas_attached'] + 1} TTIs, "
                  f"{tti_end[first['nas_attached']] - t0:.2f} s of wall time (tables built and "
                  f"uploaded on first use in scenario A)", flush=True)
        if name == "A":
            q = counts["queued_tti"]
            n_bits = STACK_BULK * STACK_BULK_BYTES * 8
            dl_t, ul_t = first["dl_all"] - q, first["ul_all"] - q
            print(f"[18 full stack, A] bulk: {STACK_BULK} x {STACK_BULK_BYTES} bytes each way "
                  f"queued at TTI {q}; DL all delivered {dl_t} TTIs later = "
                  f"{n_bits / dl_t:.0f} bits per TTI, UL {ul_t} TTIs later = "
                  f"{n_bits / ul_t:.0f} bits per TTI; wall "
                  f"{tti_end[first['dl_all']] - tti_end[q]:.2f} s for the DL bulk", flush=True)
            per = sorted(by_shape.items(), key=lambda kv: -kv[1])
            print(f"[18 full stack, A] kernel launches {counts_a}: per TTI, by shape: "
                  + "; ".join(f"{k} {shp}: {n} ({n / ttis:.3f} per TTI)" for (k, shp), n in per),
                  flush=True)
            if prof is not None:
                stack_profile(prof, (bulk["t1"] - bulk["t0"]) * 1e3)
    # D schedules a grant that A-C never do (so its first run captures that
    # bucket once); a second run of D must capture nothing
    new = [k for k in jit.keys() if k not in keys_c]
    first, ttis, gates, _ = stack_scenario("D", pkg)
    failed = [g for g, ok in gates.items() if not ok]
    check(not failed and first == STACK_JAX["D"], f"full stack, D again: gates {failed}, "
                                                   f"first TTI per state {first}")
    n_again = jit.graphs()["count"]
    print(f"[18 full stack] CUDA graphs in the cache after C {n_graphs['C']['count']}, after D "
          f"{n_graphs['D']['count']} (the buckets D alone schedules: "
          f"{[(k[0].removeprefix('srslte_tpu_torch.'), str(k[1])[:300]) for k in new]}), after "
          f"D again ({ttis} TTIs, every gate and state TTI met) {n_again}", flush=True)
    check(n_again == n_graphs["D"]["count"],
          f"full stack: {n_graphs['C']['count']} CUDA graphs after scenario C, "
          f"{n_graphs['D']['count']} after D, {n_again} after D again: the graphs grow with the "
          f"TTIs run")
    return counts_a


# ------------------------------------------------- the full stack over S1
def s1_port(device="cuda"):
    """The port's entry points for `s1_scenario`, the apps on `device`."""
    from srslte_tpu_torch import enb, ue, ue_stack
    from srslte_tpu_torch.epc import Hss
    from srslte_tpu_torch.epc.wire import EpcApp
    from srslte_tpu_torch.nas.keys import kdf_kenb
    from srslte_tpu_torch.net.s1_transport import sctp_supported
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.s1ap import s1ap_unpack
    from srslte_tpu_torch.security.milenage import compute_opc

    return types.SimpleNamespace(
        EnbApp=functools.partial(enb.EnbApp, device=device),
        UeApp=functools.partial(ue.UeApp, device=device), UeNas=ue_stack.UeNas,
        SoftUsim=ue_stack.SoftUsim, Hss=Hss, EpcApp=EpcApp, Cell=Cell, compute_opc=compute_opc,
        kdf_kenb=kdf_kenb, sctp_supported=sctp_supported, s1ap_unpack=s1ap_unpack)


def s1_wiretap(enb, epc, tti_now, log, gtpu):
    """Record each S1AP PDU as its end receives it, (TTI, "ul" or "dl", raw
    bytes) into log, and count the G-PDUs each end receives into gtpu."""
    def tap(owner, direction, pdu_of=None):
        poll = owner.poll

        def polled():
            out = poll()
            if pdu_of is None:
                gtpu[direction] += len(out)
            else:
                log.extend((tti_now[0], direction, pdu_of(x)) for x in out)
            return out
        owner.poll = polled

    gtpu.update(ul=0, dl=0)
    tap(epc.mme.server, "ul", lambda x: x[1])  # (association, PDU) at the MME
    tap(enb.s1.cli, "dl", lambda x: x)
    tap(epc.spgw.gtpu, "ul")
    tap(enb.s1.gtpu, "dl")


def s1_scenario(pkg, call=None, bulk_hooks=None):
    """Phase 19 (see S1_MAX_TTI) on the package `pkg` (`s1_port`, or the JAX
    package's classes in tests/rehearse_s1.py): S1-A, the attach through
    the EpcApp and the bulk each way between the UE and SGi; then S1-R, the
    eNB's release request and one UL packet from the released UE.
    call(label, fn, *args) makes each of the five per-TTI calls; bulk_hooks
    (start, stop) run when the bulk is queued and when it has all arrived.
    Returns (the first TTI of each state, the TTIs run, the gates as {name:
    bool}, counts, the S1AP log (TTI, direction, procedure))."""
    call = call or (lambda label, fn, *args: fn(*args))
    imsi, k = STACK_SUBSCRIBERS[0]
    cell = pkg.Cell(n_prb=STACK_PRB, id=STACK_CELL_ID, nof_ports=1)
    hss = pkg.Hss()
    hss.add_subscriber(imsi, k, op=STACK_OP)
    tcp = not pkg.sctp_supported()
    sgi = []
    epc = pkg.EpcApp(hss, force_tcp=tcp, sgi_tx=lambda ip, pkt: sgi.append((ip, pkt)))
    epc.mme.s11.settimeout(S1_S11_TIMEOUT)
    try:
        enb = pkg.EnbApp(cell, s1={"port": epc.s1_port, "force_tcp": tcp})
        ue = pkg.UeApp(cell, pkg.UeNas(pkg.SoftUsim(imsi, k, pkg.compute_opc(k, STACK_OP))))
        tti_now, raw_log, gtpu = [0], [], {}
        s1_wiretap(enb, epc, tti_now, raw_log, gtpu)
        first, sent, held, bulk = {}, None, {}, {}
        counts = {"transport": "framed TCP" if tcp else "SCTP", "queued_tti": None}

        def mark(event, cond, tti):
            if cond and event not in first:
                first[event] = tti

        for tti in range(S1_MAX_TTI):
            tti_now[0] = tti
            dl = call("enb.tx_subframe", enb.tx_subframe, tti)
            call("ue.rx_subframe", ue.rx_subframe, dl, tti)
            ul = call("ue.tx_subframe", ue.tx_subframe, tti)
            call("enb.rx_subframe", enb.rx_subframe, ul, tti)
            call("epc.step", epc.step)
            c = enb.ues.get(ue.crnti) if ue.crnti else None
            for event, cond in (("mib", ue.mib is not None), ("sib1", ue.sib1 is not None),
                                ("sib2", ue.sib2 is not None), ("s1_setup", enb.s1.setup_done),
                                ("rach_sent", ue.state == "rach_sent"),
                                ("ra_done", ue.state == "connected"),
                                ("rrc_connected", c is not None and c.rrc_state == "connected"),
                                ("ics", c is not None and bool(c.teid_ul)),
                                ("nas_attached", ue.nas.state == "attached"),
                                ("drb", ue.pdcp_drb is not None),
                                ("bearer_modified", ue.nas.ip in epc.spgw.dl_teid),
                                ("rrc_reconfigured", c is not None
                                 and c.rrc_state == "rrc_reconfigured")):
                mark(event, cond, tti)
            if sent is None and {"nas_attached", "drb", "bearer_modified"} <= set(first):
                sent = (stack_packets(STACK_BULK, STACK_SEED),
                        stack_packets(STACK_BULK, STACK_SEED + 1))
                counts["queued_tti"] = tti
                if bulk_hooks:
                    bulk_hooks[0]()
                for p in sent[0]:
                    ue.send_data(p)
                counts["dl_accepted"] = sum(epc.spgw.send_dl(ue.nas.ip, p) for p in sent[1])
                held.update(ctx=c, mme_ue_id=c.mme_ue_id, ip=ue.nas.ip,
                            kasme=epc.mme.ues[c.mme_ue_id].kasme,
                            k_int=epc.mme.ues[c.mme_ue_id].sec.k_int)
            if sent is not None and "release_requested" not in first:
                mark("dl_first", len(ue.rx_data) > 0, tti)
                mark("dl_all", len(ue.rx_data) >= len(sent[1]), tti)
                mark("ul_first", len(sgi) > 0, tti)
                mark("ul_all", len(sgi) >= len(sent[0]), tti)
                if "dl_all" in first and "ul_all" in first:
                    if bulk_hooks:
                        bulk_hooks[1]()
                    bulk.update(sgi=list(sgi), rx=list(ue.rx_data))
                    enb.s1.release_request(held["ctx"])
                    mark("release_requested", True, tti)
                continue
            if "release_requested" in first:
                mark("enb_released", ue.crnti not in enb.ues, tti)
                mark("mme_released", held["mme_ue_id"] not in epc.mme.s1_ues, tti)
                mark("session_deleted", held["ip"] not in epc.spgw.table.by_ue_ip, tti)
                released = {"enb_released", "mme_released", "session_deleted"} <= set(first)
                if "reconnect_sent" not in first and released:
                    n_sgi = len(sgi)
                    ue.send_data(S1_RECONNECT_PACKET)
                    mark("reconnect_sent", True, tti)
                elif "reconnect_sent" in first:
                    mark("reconnect_ul", S1_RECONNECT_PACKET in [p for _, p in sgi[n_sgi:]], tti)
                    if ("reconnect_ul" in first
                            or tti - first["reconnect_sent"] >= S1_RECONNECT_TTIS):
                        break
        log = [(t, d, pkg.s1ap_unpack(raw)[0]) for t, d, raw in raw_log]
        counts.update(s1ap_ul=sum(d == "ul" for _, d, _ in log),
                      s1ap_dl=sum(d == "dl" for _, d, _ in log), gtpu_ul=gtpu["ul"],
                      gtpu_dl=gtpu["dl"])
        g = {"s1_setup": enb.s1.setup_done,
             "attached": sent is not None and str(held["ip"]).startswith(
                 epc.spgw.table.ip_base + "."),
             "teid_and_kenb": (held.get("ctx") is not None and bool(held["ctx"].teid_ul)
                               and held["ctx"].kenb == pkg.kdf_kenb(held["kasme"], 0)),
             "nas_keys": sent is not None and ue.nas.sec.k_int == held["k_int"]}
        if sent is not None:
            got = bulk.get("sgi", sgi)
            g["dl_accepted"] = counts["dl_accepted"] == len(sent[1])
            g["dl_in_order"] = bulk.get("rx", ue.rx_data) == sent[1]
            g["ul_in_order"] = ([p for _, p in got] == sent[0]
                                and all(ip == held["ip"] for ip, _ in got))
        g["released_both_ends"] = {"enb_released", "mme_released",
                                   "session_deleted"} <= set(first)
        return first, tti + 1, g, counts, log
    finally:
        epc.close()


def s1_states_check(first, label):
    """Phase 19's state TTIs equal to the JAX package's (S1_JAX)."""
    want = S1_JAX["first"]
    diff = {k: (first.get(k), want.get(k)) for k in set(first) | set(want)
            if first.get(k) != want.get(k)}
    check(not diff, f"S1 wire, {label}: first TTI per state differs from the JAX package's "
                    f"(port, JAX): {diff}")


def phase_s1(smi, profile=False):
    """The full stack over the S1 wire at 20 MHz (see S1_MAX_TTI): S1-A and
    S1-R through EnbApp(s1=...), UeApp and the port's EpcApp on the card,
    gated on the reference's assertions, on every packet once and in order,
    on the S1AP procedures and the state TTIs of the JAX package's run
    (S1_JAX), and on the release on both ends; a second, untimed run counts
    the host synchronisations.  Returns the first run's kernel launch
    counts."""
    pkg = s1_port()
    times, tti_end, by_shape, bulk = {}, [], collections.Counter(), {}
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def bulk_start():
        if prof is not None:
            prof.start()
        bulk.update(t0=time.perf_counter())

    def bulk_stop():
        torch.cuda.synchronize()
        bulk.update(t1=time.perf_counter(), cache_a=table_cache())
        if prof is not None:
            prof.stop()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    with launch_shapes(by_shape):
        first, ttis, gates, counts, log = s1_scenario(pkg, stack_timer(times, tti_end),
                                                      (bulk_start, bulk_stop))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for k in ("siso_windowed", "viterbi_decode"):
        check(launches[k] > 0, f"the S1 wire path did not launch the {k} kernel")
    check(any(k == "siso_windowed" and shp.endswith(" T=0") for k, shp in by_shape),
          "no code block of K < 256 went through the SISO kernel on the S1 wire path")
    held = ({("siso_windowed", f"K={K} L={L} T={T}") for _, K, L, T in SISO_SHAPES.values()}
            | {("viterbi_decode", f"len={n}") for _, n in VIT_SHAPES.values()})
    unheld = sorted({(k, shp) for k, shp in by_shape
                     if (k, shp.split(" ", 1)[1].replace(" tail_biting=True", "")) not in held})
    check(not unheld, f"S1 wire: shapes phase 3 does not hold: {unheld}")
    failed = [g for g, ok in gates.items() if not ok]
    check(not failed, f"S1 wire: gates failed: {failed}")
    procs = tuple(f"{d}:{p}" for _, d, p in log)
    check(procs == S1_JAX["procedures"], f"S1 wire: S1AP procedures {procs} differ from the "
                                         f"JAX package's {S1_JAX['procedures']}")
    s1_states_check(first, "S1-A and S1-R")
    if "reconnect_ul" in S1_JAX["first"]:
        check("reconnect_ul" in first, "S1 wire: the released UE's packet did not reach SGi")
    n_tab, mb_tab, n_seq, mb_seq = table_cache()
    print(f"[19 S1 wire] S1AP over {counts['transport']}; {ttis} TTIs in {wall:.2f} s of wall "
          f"time; every gate passed ({', '.join(gates)}); S1AP procedures in the JAX package's "
          f"order: {', '.join(procs)}", flush=True)
    print(f"[19 S1 wire] first TTI per state {first}, equal to the JAX package's; the released "
          f"UE's packet "
          f"{'reached SGi at TTI ' + str(first['reconnect_ul']) if 'reconnect_ul' in first else 'did not reach SGi'} "
          f"(JAX: {'reached' if 'reconnect_ul' in S1_JAX['first'] else 'did not reach'}; "
          f"its apps have no reconnect over the wire)", flush=True)
    print(f"[19 S1 wire] S1AP PDUs: {counts['s1ap_ul']} eNB -> MME, {counts['s1ap_dl']} MME -> "
          f"eNB; GTP-U G-PDUs: {counts['gtpu_ul']} eNB -> S/P-GW, {counts['gtpu_dl']} S/P-GW -> "
          f"eNB; {smi}", flush=True)
    for label, ms in times.items():
        print(f"[19 S1 wire] {label}: {len(ms)} calls, ms median {float(np.median(ms)):.3f}, "
              f"p99 {float(np.percentile(ms, 99)):.3f}, max {max(ms):.3f} (LTE's TTI: 1 ms)",
              flush=True)
    a = first["nas_attached"]
    print(f"[19 S1 wire] attach: {a + 1} TTIs, {tti_end[a] - t0:.2f} s of wall time; bulk: "
          f"{STACK_BULK} x {STACK_BULK_BYTES} bytes each way queued at TTI {counts['queued_tti']}, "
          f"DL all at SGi -> UE {first['dl_all'] - counts['queued_tti']} TTIs later, UL all at "
          f"SGi {first['ul_all'] - counts['queued_tti']} TTIs later; "
          f"{bulk['t1'] - bulk['t0']:.2f} s of wall time", flush=True)
    print(f"[19 S1 wire] peak device memory {peak / 1e6:.1f} MB ({(peak - before) / 1e6:.1f} MB "
          f"above what was allocated before); table cache after S1-A: {bulk['cache_a'][0]} "
          f"shared entries, {bulk['cache_a'][1]:.2f} MB, {bulk['cache_a'][2]} per-UE sequences, "
          f"{bulk['cache_a'][3]:.2f} MB; after S1-R: {n_tab} entries, {mb_tab:.2f} MB, {n_seq} "
          f"sequences, {mb_seq:.2f} MB; {smi}", flush=True)
    per = sorted(by_shape.items(), key=lambda kv: -kv[1])
    print(f"[19 S1 wire] kernel launches {launches}: per TTI, by shape: "
          + "; ".join(f"{k} {shp}: {n} ({n / ttis:.3f} per TTI)" for (k, shp), n in per),
          flush=True)
    (first2, ttis2, gates2, _, _), n_sync, _ = count_syncs(lambda: s1_scenario(pkg), ())
    check(all(gates2.values()), f"S1 wire, second run: gates failed: "
                                f"{[g for g, ok in gates2.items() if not ok]}")
    s1_states_check(first2, "second run")
    print(f"[19 S1 wire] second run (untimed, CUDA sync debug mode): the same gates and states; "
          f"{n_sync} host synchronisations in {ttis2} TTIs = {n_sync / ttis2:.2f} per TTI",
          flush=True)
    if prof is not None:
        stack_profile(prof, (bulk["t1"] - bulk["t0"]) * 1e3, "S1-A bulk")
    return launches


class NrChain:
    """One deployment of phase 20 and the two sides of its path, on
    NrCarrier(NR_PRB, mu 0) in slot NR_SLOT for RNTI NR_RNTI:

    - "dl": DCI 1_0 over all 52 PRB at mcs 27 (the qam64 table, which DCI 1_0
      always signals), put by NrPdcch at the first L=4 location of NR_SS on
      Coreset.full(48, duration 1); its PDSCH on symbols 1-13, type-1 DMRS
      at l 2 (TBS 39936: 5 BG1 code blocks of Zc 384, G 44928);
    - "dl256": a grant-based PDSCH at mcs 27 of the qam256 table on 52 PRB
      (TBS 55304: 7 x Zc 384);
    - "mimo2": NrPdsch(n_layers=2), 64QAM at rate 0.5 over the whole slot,
      ports 1000/1001 through the 2x2 channel NR_H2 to 2 rx;
    - "ul": NrPusch on the grant of a DCI 0_0 over 52 PRB at mcs 27.

    Every path but "mimo2" goes through the flat gain NR_H.  `device="cpu"`
    lets tests/rehearse_nr.py build the same stimulus on the host."""

    BUCKETS = {"dl": (39936, 44928, 5, 384), "dl256": (55304, 59904, 7, 384),
               "mimo2": (48672, 97344, 6, 384), "ul": (39936, 44928, 5, 384)}

    def __init__(self, kind, device="cuda"):
        from srslte_tpu_torch.phy import nr

        self.kind, self.device = kind, device
        self.carrier = nr.NrCarrier(n_prb=NR_PRB, mu=0)
        self.coreset = nr.Coreset.full(48, duration=1)
        self.ss = nr.NrSearchSpace(ue_specific=True, nof_candidates=NR_SS)
        self.pdcch = nr.NrPdcch(self.carrier, self.coreset, slot=NR_SLOT)
        self.dci = None
        if kind == "dl":
            self.dci = nr.Dci10(rb_start=0, l_rb=NR_PRB, mcs=NR_MCS)
            self.dci_bits = nr.pack_dci_10(self.dci, NR_PRB)
            check(nr.unpack_dci_10(self.dci_bits, NR_PRB) == self.dci, "DCI 1_0 round trip")
            self.pdsch = self.pdsch_for(self.dci.grant(NR_PRB))
        elif kind == "ul":
            self.dci = nr.Dci00(rb_start=0, l_rb=NR_PRB, mcs=NR_MCS)
            self.dci_bits = nr.pack_dci_00(self.dci, NR_PRB, NR_PRB)
            check(nr.unpack_dci_00(self.dci_bits, NR_PRB) == self.dci, "DCI 0_0 round trip")
            self.pdsch = nr.NrPusch(self.carrier, rnti=NR_RNTI, slot=NR_SLOT + 4,
                                    grant=self.dci.grant(NR_PRB))
        elif kind == "dl256":
            self.pdsch = self.pdsch_for(nr.NrGrant(0, NR_PRB, NR_MCS, mcs_table="qam256"))
        else:
            self.pdsch = nr.NrPdsch(self.carrier, mcs_qm=6, rate=0.5, rnti=NR_RNTI,
                                    slot=NR_SLOT, n_layers=2)
        cfg = self.pdsch.cfg
        got = (cfg.tbs, cfg.G, cfg.seg.C, cfg.seg.zc)
        check(got == self.BUCKETS[kind], f"NR {kind}: unexpected bucket {got}")
        self.locations = self.search_space(NR_RNTI)
        self.tx_loc = self.locations[0]  # the first L=4 location
        self.h2 = torch.as_tensor(np.array(NR_H2, np.complex64), device=device)

    def pdsch_for(self, grant):
        from srslte_tpu_torch.phy.nr import NrPdsch

        return NrPdsch(self.carrier, rnti=NR_RNTI, slot=NR_SLOT, grant=grant)

    def search_space(self, rnti):
        """(first CCE, L) of every candidate of NR_SS for `rnti`, L 4 first."""
        from srslte_tpu_torch.phy.nr import pdcch_nr_locations

        return [(n, 1 << a) for a in (2, 3)
                for n in pdcch_nr_locations(self.coreset, self.ss, rnti, a, NR_SLOT)]

    def encode(self, seed, batch=BATCH):
        """(bits [B, tbs] on the device, received grids: [B, 14, 624], or
        [B, 2rx, 14, 624] for "mimo2"), noise-free."""
        rng = np.random.default_rng(seed)
        bits = torch.as_tensor(rng.integers(0, 2, (batch, self.pdsch.tbs), dtype=np.uint8),
                               device=self.device)
        tx = self.pdsch.encode(bits)
        if self.kind == "dl":
            tx = self.pdcch.encode(tx, self.dci_bits, NR_RNTI, *self.tx_loc)
        if self.kind == "mimo2":
            return bits, torch.einsum("rp,bpsk->brsk", self.h2, tx)
        return bits, tx * complex(NR_H)

    @staticmethod
    def noisy(rx, snr_db, gen):
        """rx with complex AWGN of variance 10^(-snr_db/10) per RE (the
        transmitted symbols have unit power), drawn anew from the host
        generator `gen` and moved to rx's device, so that
        tests/rehearse_nr.py decodes the same grid on the CPU."""
        sigma = math.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
        n = (torch.randn((2,) + rx.shape, generator=gen) * sigma).to(rx.device)
        return rx + torch.complex(n[0], n[1])

    def search(self, grid, rnti=NR_RNTI):
        """The UE's blind search of one slot's grid for `rnti`."""
        return self.pdcch.search(grid, rnti, len(self.dci_bits), self.search_space(rnti))


def nr_score(bits, sent, ok, label):
    """TBs that pass their CRC; fails if one that passed differs from the
    bits sent."""
    check(bits.shape == sent.shape and bits.dtype == torch.uint8, f"{label}: TB shape or type")
    check(bool((bits[ok] == sent[ok]).all()), f"{label}: a TB that passed CRC differs from "
                                              f"the bits sent")
    return int(ok.sum())


def nr_searches(chain, rx, label):
    """The DCI search in the first NR_SEARCHED slots for the right RNTI (each
    must find the DCI sent at its location) and for NR_WRONG_RNTI (each must
    find nothing).  Returns (the grant read back, ms per right search)."""
    from srslte_tpu_torch.phy.nr import unpack_dci_10

    times = []
    for s in range(NR_SEARCHED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit = chain.search(rx[s])
        times.append((time.perf_counter() - t0) * 1e3)
        check(hit is not None and hit[0] == chain.tx_loc
              and np.array_equal(hit[1], chain.dci_bits),
              f"{label}: slot {s}: the DCI read back is {hit}")
        check(chain.search(rx[s], NR_WRONG_RNTI) is None,
              f"{label}: slot {s}: a DCI found under RNTI {NR_WRONG_RNTI:#x}")
    dci = unpack_dci_10(hit[1], NR_PRB)
    check(dci == chain.dci, f"{label}: DCI {dci} unpacked, {chain.dci} sent")
    return dci.grant(NR_PRB), float(np.median(times))


def nr_dispatch_counted(run):
    """run() with the peak device memory reset before: (result, peak MB,
    MB above what was allocated before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, peak / 1e6, (peak - before) / 1e6


def device_launches(run):
    """(kernels and copies on the card, device busy ms, host ms) of one run()
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, busy_us = device_rows(prof)
    return sum(r[1] for r in rows), busy_us / 1e3, wall


def phase_nr_path(label, chain, seed, profile=False):
    """One NR deployment: the stimulus, a clean dispatch (every TB but the
    slots NR_JAX_CLEAN[kind] that the JAX package loses too), a noisy
    dispatch at NR_SNR_DB[kind] (TB ok >= 80 %, and the slots lost those
    NR_JAX_NOISY[kind] that the JAX package loses on the same grid) with its
    peak memory, then the median of N_TIMED dispatches.  For "dl" the UE
    first searches the DCI in NR_SEARCHED slots and decodes with the grant
    it read back.  Returns (median ms, the noisy stimulus, the PDSCH
    decoded)."""
    t0 = time.perf_counter()
    bits, rx = chain.encode(seed)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(torch.view_as_real(rx)).all()), f"{label}: stimulus values")
    cfg = chain.pdsch.cfg
    print(f"[{label}] stimulus: {BATCH} slots encoded on the card in "
          f"{time.perf_counter() - t0:.1f} s: TBS {cfg.tbs}, G {cfg.G}, {cfg.seg.C} BG"
          f"{cfg.seg.bg} code blocks of Zc {cfg.seg.zc} per slot", flush=True)
    snr = NR_SNR_DB[chain.kind]
    gen = torch.Generator()
    gen.manual_seed(seed)
    pdsch = chain.pdsch
    for name, r in (("clean", rx), (f"{snr} dB", chain.noisy(rx, snr, gen))):
        if chain.kind == "dl":
            grant, search_ms = nr_searches(chain, r, f"{label}, {name}")
            pdsch = chain.pdsch_for(grant)
            check(pdsch == chain.pdsch, f"{label}: the grant read back gives another PDSCH")
            print(f"[{label}, {name}] DCI search in {NR_SEARCHED} slots ({len(chain.locations)} "
                  f"candidates each, polar N {512}, list 8): every DCI found at {chain.tx_loc} "
                  f"and equal to the one sent ({chain.dci}); none under RNTI "
                  f"{NR_WRONG_RNTI:#x}; {search_ms:.2f} ms per search (median)", flush=True)
        (out, ok, _), peak, rise = nr_dispatch_counted(lambda: pdsch.decode(r))
        n_ok = nr_score(out, bits, ok, f"{label}, {name}")
        lost = tuple(np.where(~ok.cpu().numpy())[0].tolist())
        jax_lost, slack = ((NR_JAX_CLEAN, 0) if name == "clean" else
                           (NR_JAX_NOISY, NR_NOISY_SLACK))
        jax_lost = jax_lost[chain.kind]
        differ = sorted(set(lost) ^ set(jax_lost))
        check(len(differ) <= slack, f"{label}, {name}: TB ok {n_ok}/{BATCH}, slots {lost} lost "
                                    f"(the JAX package loses {jax_lost} of this grid)")
        if name != "clean":
            check(n_ok >= 0.8 * BATCH, f"{label}, {name}: TB ok {n_ok}/{BATCH}")
            noisy = r
        print(f"[{label}, {name}] TB ok {n_ok}/{BATCH}, each equal to the bits sent; slots lost "
              f"{lost}, the JAX package's on this grid {jax_lost}, differing {differ} (at most "
              f"{slack}); peak device memory {peak:.1f} MB ({rise:.1f} MB above what was "
              f"allocated before)", flush=True)
    ms, (out, ok, _) = median_ms(lambda: pdsch.decode(noisy))
    n_ok = nr_score(out, bits, ok, label)
    print(f"[{label}, {snr} dB] {N_TIMED} timed dispatches of {BATCH} slots: median "
          f"{ms:.3f} ms/dispatch = {BATCH / (ms * 1e-3):.1f} slots/s ({BATCH / ms:.4f} x real "
          f"time: 1000 slots/s at mu 0); last TB ok {n_ok}/{BATCH}", flush=True)
    if profile:
        phase_profile(label, lambda: pdsch.decode(noisy), ms)
    return ms, noisy, pdsch


def phase_nr(smi, profile=False):
    """Phase 20, the slice's main path: the NR PHY at 52 PRB (NrChain)."""
    from srslte_tpu_torch.phy.fec.polar import PolarCode, input_interleaver, polar_decode_list
    from srslte_tpu_torch.phy.nr import NrPdcch, NrPdsch, dlsch_nr

    dl = NrChain("dl")
    reset_counts()
    ms, rx, pdsch = phase_nr_path("20a NR DL", dl, NR_SEED, profile)
    print(f"[20a NR DL] CUDA kernel launches on this path: {read_counts()} (LDPC and polar are "
          f"plain PyTorch)", flush=True)
    # the stages of one dispatch, a synchronise after each
    t0 = time.perf_counter()
    stages = [("start", t0)]
    hooks = ((NrPdsch, "demod_llr", "demod_llr"),
             (dlsch_nr, "nr_dlsch_combine", "rate_recovery"),
             (dlsch_nr, "ldpc_decode", "ldpc_decode"),
             (dlsch_nr.crcmod, "crc_ok_device", "crc"))
    with stage_marks(stages, hooks):
        torch.cuda.synchronize()
        stages[0] = ("start", time.perf_counter())
        type(pdsch).decode.__wrapped__(pdsch, rx)
    split = ", ".join(f"{nm} {(t - stages[i][1]) * 1e3:.2f}"
                      for i, (nm, t) in enumerate(stages[1:]))
    print(f"[20a NR DL] one more dispatch with a synchronise after each stage, ms (decode "
          f"eager, its __wrapped__; crc: code blocks, then transport blocks): {split}",
          flush=True)
    # launches of one LDPC decode and one list decode at the path's shapes
    cfg = pdsch.cfg
    w = dlsch_nr.nr_dlsch_combine(pdsch.demod_llr(rx)[0], cfg)
    n_ldpc, busy_ldpc, wall_ldpc = device_launches(
        lambda: dlsch_nr.ldpc_decode(w, cfg.graph, n_iter=10))
    code = PolarCode(K=len(dl.dci_bits) + 24, E=2 * 4 * 6 * 9, n_max=9)
    flat = rx[0].reshape(-1)
    llr = torch.stack([dl.pdcch.candidate_llr(flat, NR_RNTI, n, 4) for n, _ in
                       dl.locations[:2]])
    n_polar, busy_polar, wall_polar = device_launches(lambda: polar_decode_list(llr, code, L=8))
    print(f"[20a NR DL] one ldpc_decode of {BATCH} x {cfg.seg.C} code blocks (BG{cfg.seg.bg} Zc "
          f"{cfg.seg.zc}, 10 iterations): {n_ldpc} kernels and copies, device busy "
          f"{busy_ldpc:.2f} ms of {wall_ldpc:.2f} ms on the host clock (under the profiler); one "
          f"polar_decode_list of the 2 L=4 candidates (K {code.K}, E {code.E}, N {code.N}, list "
          f"8): {n_polar} kernels and copies, device busy {busy_polar:.2f} ms of "
          f"{wall_polar:.2f} ms", flush=True)

    def ue_dispatch():
        for s in range(NR_SEARCHED):
            dl.search(rx[s])
        return pdsch.decode(rx)
    _, n_sync, per = count_syncs(ue_dispatch, ((NrPdcch, "search", "dci_search"),
                                               (NrPdsch, "decode", "pdsch_decode")))
    print(f"[20a NR DL] host synchronisations (CUDA sync debug mode) in one dispatch of "
          f"{NR_SEARCHED} DCI searches and the PDSCH decode of {BATCH} slots: {n_sync} = "
          f"{n_sync / BATCH:.3f} per slot; by stage {per}; {smi}", flush=True)

    phase_nr_path("20b NR DL 256QAM", NrChain("dl256"), NR_SEED + 1)
    phase_nr_path("20c NR DL 2 layers", NrChain("mimo2"), NR_SEED + 2)
    phase_nr_path("20d NR UL PUSCH", NrChain("ul"), NR_SEED + 3)
    phase_nr_control(dl.carrier)
    return ms


def phase_nr_control(carrier):
    """Phase 20d's control: PUCCH formats 0-4 and UCI (the block code and
    the polar code with PC bits) as tests/test_nr_uci_pucch.py drives them,
    and a CSI-RS measurement turned into a packed report carried on format
    2 (tests/test_nr_csi.py); each on one slot through the gain 0.9 e^0.8j
    and AWGN of 0.03 per component (0.05 and 0.02 for the CSI-RS and its
    report), every payload equal to what was sent."""
    from srslte_tpu_torch.phy.fec.polar import PolarCode
    from srslte_tpu_torch.phy.nr import csi, csi_rs, uci_nr
    from srslte_tpu_torch.phy.nr.params import NSYMB_SLOT
    from srslte_tpu_torch.phy.nr.pucch_nr import NrPucch, NrPucchResource

    gen = torch.Generator(device="cuda")
    gen.manual_seed(NR_SEED + 4)
    rng = np.random.default_rng(NR_SEED + 4)
    empty = torch.zeros((NSYMB_SLOT, carrier.nof_re), dtype=torch.complex64, device="cuda")

    def chan(g, n=0.03, h0=0.9 * np.exp(0.8j)):
        z = torch.randn((2,) + g.shape, generator=gen, device="cuda") * n
        return g * complex(h0) + torch.complex(z[0], z[1])

    pu = NrPucch(carrier, slot=NR_SLOT)
    done, t0 = [], time.perf_counter()
    res = NrPucchResource(format=0, starting_prb=0, start_symbol=12, nof_symbols=2,
                          initial_cyclic_shift=3)
    for m_cs in (0, 6):
        got, corr = pu.format0_measure(chan(pu.format0_encode(empty, res, m_cs)), res, (0, 6))
        check(got == m_cs and corr > 0.7, f"PUCCH format 0: m_cs {got} (sent {m_cs}), {corr}")
    done.append("format 0 (m_cs 0, 6)")
    res = NrPucchResource(format=1, starting_prb=51, start_symbol=4, nof_symbols=10,
                          initial_cyclic_shift=5, time_domain_occ=2)
    for bits in ([0], [1], [0, 1], [1, 1]):
        got, metric = pu.format1_decode(
            chan(pu.format1_encode(empty, res, np.array(bits, np.uint8))), res, len(bits))
        check(got.tolist() == bits and metric > 0.5, f"PUCCH format 1: {got} (sent {bits})")
    done.append("format 1 (1 and 2 bits)")
    cases = [(2, dict(starting_prb=10, start_symbol=13, nof_symbols=1, nof_prb=1), 4),
             (2, dict(starting_prb=10, start_symbol=13, nof_symbols=1, nof_prb=2), 11),
             (2, dict(starting_prb=10, start_symbol=13, nof_symbols=1, nof_prb=4), 22),
             (2, dict(starting_prb=10, start_symbol=12, nof_symbols=2, nof_prb=2), 16),
             (3, dict(starting_prb=20, start_symbol=10, nof_symbols=4, nof_prb=1), 16),
             (3, dict(starting_prb=20, start_symbol=4, nof_symbols=10, nof_prb=2), 40),
             (3, dict(starting_prb=20, start_symbol=0, nof_symbols=14, nof_prb=3,
                      additional_dmrs=True), 60),
             (4, dict(starting_prb=5, start_symbol=0, nof_symbols=14, occ_length=2,
                      occ_index=0), 10),
             (4, dict(starting_prb=5, start_symbol=0, nof_symbols=14, occ_length=2,
                      occ_index=1), 14),
             (4, dict(starting_prb=5, start_symbol=0, nof_symbols=14, occ_length=4,
                      occ_index=2), 8)]
    for fmt, kw, a in cases:
        res = NrPucchResource(format=fmt, **kw)
        uci = rng.integers(0, 2, a).astype(np.uint8)
        enc, dec = ((pu.format2_encode, pu.format2_decode) if fmt == 2 else
                    (pu.format34_encode, pu.format34_decode))
        got, ok = dec(chan(enc(empty, res, uci, rnti=NR_RNTI)), res, a, rnti=NR_RNTI)
        check(ok and np.array_equal(got, uci), f"PUCCH format {fmt} {kw}: {a} UCI bits")
    done.append(f"formats 2-4 ({len(cases)} resources, UCI of 4-60 bits)")
    # UCI alone through every regime, the polar ones with PC bits at K 18-25
    pc = 0
    for a, e in ((1, 24), (2, 24), (5, 64), (11, 96), (14, 160), (22, 300), (40, 512),
                 (400, 2200)):
        bits = rng.integers(0, 2, a).astype(np.uint8)
        cw = uci_nr.uci_encode(torch.as_tensor(bits, device="cuda"), e).to(torch.float32)
        y = (1 - 2 * cw) + 0.4 * torch.randn(cw.shape, generator=gen, device="cuda")
        got, ok = uci_nr.uci_decode(-y * 8, a)
        check(ok and np.array_equal(got, bits), f"UCI of {a} bits in {e}")
        if a > 11:
            _, _, k_r, e_r = uci_nr._polar_params(a, e)
            pc += PolarCode(K=k_r, E=e_r, n_max=10, with_pc=True).n_pc > 0
    noise = torch.as_tensor(rng.standard_normal(300).astype(np.float32) * 10, device="cuda")
    check(not uci_nr.uci_decode(noise, 22)[1], "UCI: CRC passed on noise")
    done.append(f"UCI 1-400 bits ({pc} of the polar codes with PC bits), none on noise")
    # CSI: NZP-CSI-RS -> measure -> quantify -> pack -> format 2 -> unpack
    res = csi_rs.NzpCsiRs(row=1, nof_rb=NR_PRB)
    rx = chan(csi_rs.csi_rs_put(res, carrier, NR_SLOT, empty), n=0.05, h0=0.9 * np.exp(0.4j))
    meas = csi_rs.csi_rs_measure(res, carrier, NR_SLOT, rx)
    snr_db = float(meas["snr_db"])
    want = 10 * np.log10(0.81 / (2 * 0.05 ** 2))
    check(abs(snr_db - want) < 2.0, f"CSI-RS SNR {snr_db:.2f} dB, {want:.2f} dB expected")
    cfg = csi.CsiReportCfg(periodic=csi.CsiPeriodic(period=10, offset=NR_SLOT))
    check(csi.report_trigger(cfg, NR_SLOT), "CSI report not triggered")
    report = csi.quantify(cfg, csi.CsiMeasurements(wideband_snr_db=snr_db))
    pres = NrPucchResource(format=2, starting_prb=10, start_symbol=13, nof_symbols=1, nof_prb=1)
    uci = csi.pack(cfg, report)
    got, ok = pu.format2_decode(chan(pu.format2_encode(empty, pres, uci, rnti=NR_RNTI),
                                     n=0.02, h0=0.9 * np.exp(0.4j)),
                                pres, csi.nof_bits(cfg), rnti=NR_RNTI)
    check(ok and csi.unpack(cfg, got) == report, f"CSI report {got} (sent {report})")
    done.append(f"CSI (measured {snr_db:.2f} dB -> CQI {report.cqi}, packed, over format 2, "
                f"unpacked equal)")
    print(f"[20d NR UL control] every payload equal to what was sent: {'; '.join(done)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def nr_stack_port(device):
    """The port's NR stack entry points, for `nr_stack_scenario`, on
    `device`; `noisy(grid, sigma, gen)` adds complex AWGN of sigma per
    component drawn from the host generator `gen`."""
    from srslte_tpu_torch import nr_stack, nr_worker, vnf
    from srslte_tpu_torch.phy.nr import Coreset, NrCarrier

    def noisy(grid, sigma, gen):
        n = (torch.randn((2,) + tuple(grid.shape), generator=gen) * sigma).to(grid.device)
        return grid + torch.complex(n[0], n[1])

    return types.SimpleNamespace(
        NrCarrier=NrCarrier, Coreset=Coreset,
        NrWorkerCommon=functools.partial(nr_worker.NrWorkerCommon, device=device),
        GnbNrWorker=nr_worker.GnbNrWorker, UeNrWorker=nr_worker.UeNrWorker,
        GnbNrStack=nr_stack.GnbNrStack, UeNrStack=nr_stack.UeNrStack, vnf=vnf, noisy=noisy)


def nr_stack_packets(tb_bytes):
    """NRS_PACKETS seeded packets of 40-1500 bytes; the sixth spans several
    RLC segments (2.5 TBs)."""
    rng = np.random.default_rng(NRS_SEEDS["stack"])
    sizes = [int(n) for n in rng.integers(40, 1500, NRS_PACKETS)]
    sizes[5] = 5 * tb_bytes // 2
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


def nr_stack_workers(pkg):
    """(common, gNB worker, UE worker) of phase 21's deployment."""
    car = pkg.NrCarrier(n_prb=NRS_PRB, n_id=NRS_CELL_ID)
    cset = pkg.Coreset.full(48, duration=1, id=1)
    common = pkg.NrWorkerCommon(carrier=car, coreset=cset, mcs=NRS_MCS, prb_start=0,
                                n_prb=NRS_PRB)
    check(common.phy_grant(0).tbs == NRS_TBS, f"NR stack TBS {common.phy_grant(0).tbs}")
    return common, pkg.GnbNrWorker(common), pkg.UeNrWorker(common)


def nr_stack_scenario(name, pkg, call=None):
    """Scenario `name` ("harq", "stack", see NRS_PRB) of phase 21 on the
    package `pkg` (`nr_stack_port`, or the JAX package's classes in
    tests/rehearse_nr_stack.py).  call(label, fn, *args) makes each of the
    three per-slot calls (default: a plain call).  Returns {"timeline": per
    slot (pid, rv, "A" or "N" as the gNB decodes the PUCCH) or None when
    idle, "delivered_at": the slots that delivered a TB, "n_retx", "dropped",
    "slots", and the gates as {name: bool}}."""
    call = call or (lambda label, fn, *args: fn(*args))
    _, gnb, ue = nr_stack_workers(pkg)
    rng = np.random.default_rng(NRS_SEEDS[name])
    gen = torch.Generator()
    gen.manual_seed(NRS_SEEDS[name])
    if name == "harq":
        sent = [rng.integers(0, 2, NRS_TBS).astype(np.uint8) for _ in range(NRS_HARQ_TBS)]
        for bits in sent:
            gnb.tx_data(bits)
        snr, ul_noise = NRS_HARQ_SNR_DB, True
    else:
        gnb_s, ue_s = pkg.GnbNrStack(gnb, k_enc=NRS_KEY), pkg.UeNrStack(ue, k_enc=NRS_KEY)
        sent = nr_stack_packets(NRS_TBS // 8)
        for pkt in sent:
            gnb_s.send_packet(pkt)
        gnb_s.pump_tx()
        n_tbs = len(gnb.queue)
        snr, ul_noise = NRS_STACK_SNR_DB, False
    sigma = 10 ** (-snr / 20) / math.sqrt(2)
    timeline, delivered_at, got = [], [], []
    slots = 0
    while (gnb.queue or gnb._nacked or gnb._awaiting) and slots < NRS_MAX_SLOTS[name]:
        slot = slots % 2
        grid = call("tx_slot", gnb.tx_slot, slot)
        slots += 1
        if grid is None:
            timeline.append(None)
            continue
        pid, rv = list(gnb._awaiting.items())[-1]
        ul = call("rx_slot", ue.rx_slot, pkg.noisy(grid, sigma, gen), slot)
        check(ul is not None, f"NR stack {name}: slot {slots - 1}: the UE found no DCI")
        if ue.delivered:
            delivered_at.append(slots - 1)
            got.extend(ue.delivered if name == "harq" else ())
        call("rx_ul_slot", gnb.rx_ul_slot, pkg.noisy(ul, sigma, gen) if ul_noise else ul, slot)
        timeline.append((pid, rv, "N" if pid in gnb._nacked else "A"))
        if name == "harq":
            ue.delivered.clear()
        else:
            ue_s.pump_rx()
    out = {"timeline": tuple(timeline), "delivered_at": tuple(delivered_at),
           "n_retx": sum(1 for t in timeline if t is not None and t[1] != 0),
           "dropped": gnb.dropped, "slots": slots}
    gates = {"dropped == 0": gnb.dropped == 0, "all sent": not (gnb.queue or gnb._nacked
                                                               or gnb._awaiting)}
    if name == "harq":
        gates["every TB delivered once, in order, equal to the bits sent"] = (
            len(got) == len(sent) and all(np.array_equal(a, b) for a, b in zip(got, sent)))
        gates["a retransmission"] = out["n_retx"] > 0
    else:
        out["tbs_queued"] = n_tbs
        gates["the long packet took several TBs"] = n_tbs >= NRS_PACKETS + 2
        gates["every packet once and in order"] = ue_s.received == sent
        gates["pdcp.rx_next == packets"] = ue_s.pdcp.rx_next == len(sent)
    out["gates"] = gates
    return out


def nr_vnf_scenario(pkg, call=None):
    """Phase 21c on the package `pkg`: NRS_VNF_SLOTS slots, each with one
    seeded MAC TB that GnbVnf (answering from a thread) hands to GnbPnf over
    loopback UDP, the gNB worker encodes, UePnf decodes (noiseless) and
    sends to UeVnf as DL_IND, and whose PUCCH ACK the gNB worker decodes.
    Returns {"delivered": TBs byte-equal at UeVnf, "acked": slots whose ACK
    cleared the HARQ process, "slots"}."""
    import threading

    call = call or (lambda label, fn, *args: fn(*args))
    v = pkg.vnf
    _, gnb, ue = nr_stack_workers(pkg)
    # ephemeral loopback ports: bind to 0 then cross-wire (tests/test_vnf.py)
    gnb_pnf_link = v._Udp(0, 0)
    gnb_vnf_link = v._Udp(0, gnb_pnf_link.port)
    gnb_pnf_link.peer = ("127.0.0.1", gnb_vnf_link.port)
    ue_pnf_link = v._Udp(0, 0)
    ue_vnf_link = v._Udp(0, ue_pnf_link.port)
    ue_pnf_link.peer = ("127.0.0.1", ue_vnf_link.port)
    links = (gnb_pnf_link, gnb_vnf_link, ue_pnf_link, ue_vnf_link)
    gnb_pnf, gnb_vnf = v.GnbPnf(gnb, gnb_pnf_link), v.GnbVnf(gnb_vnf_link)
    ue_pnf, ue_vnf = v.UePnf(ue, ue_pnf_link), v.UeVnf(ue_vnf_link)
    rng = np.random.default_rng(NRS_SEEDS["vnf"])
    delivered = acked = 0
    try:
        for tti in range(NRS_VNF_SLOTS):
            tb = rng.integers(0, 256, NRS_TBS // 8, dtype=np.uint8).tobytes()
            gnb_vnf.tx_queue.append(tb)
            errors = []

            def answer():
                try:
                    errors.append(gnb_vnf.handle_one() != v.SF_IND)
                except Exception as e:  # a timeout fails the slot below
                    errors.append(e)
            th = threading.Thread(target=answer)
            th.start()
            grid = call("pnf.run_slot", gnb_pnf.run_slot, tti)
            th.join()
            check(errors == [False], f"VNF slot {tti}: the VNF's answer failed: {errors}")
            check(grid is not None, f"VNF slot {tti}: the queued TB was not scheduled")
            ul = call("ue_pnf.run_slot", ue_pnf.run_slot, grid, tti)
            check(ul is not None, f"VNF slot {tti}: the UE found no DCI")
            check(ue_vnf.handle_one() == v.DL_IND, f"VNF slot {tti}: no DL_IND")
            call("rx_ul_slot", gnb.rx_ul_slot, ul, tti % gnb_pnf.slot_mod)
            acked += not gnb._awaiting and not gnb._nacked
            delivered += len(ue_vnf.rx_tbs) == tti + 1 and ue_vnf.rx_tbs[-1] == tb
    finally:
        for link in links:
            link.close()
    return {"delivered": delivered, "acked": acked, "slots": NRS_VNF_SLOTS}


def nr_stack_gates(name, out):
    """The scenario's own gates, and its timeline, delivery slots and
    retransmissions equal to NR_STACK_JAX's."""
    for gate, ok in out["gates"].items():
        check(ok, f"21 NR stack {name}: {gate} fails ({out})")
    want = NR_STACK_JAX[name]
    got_t, want_t = out["timeline"], want["timeline"]
    differ = [i for i in range(max(len(got_t), len(want_t)))
              if (got_t[i] if i < len(got_t) else None) != (want_t[i] if i < len(want_t) else None)]
    check(not differ, f"21 NR stack {name}: slots {differ} differ from the JAX package's "
                      f"timeline: {got_t} against {want_t}")
    check(out["delivered_at"] == want["delivered_at"] and out["n_retx"] == want["n_retx"],
          f"21 NR stack {name}: delivered at {out['delivered_at']}, {out['n_retx']} retx; "
          f"the JAX package: {want['delivered_at']}, {want['n_retx']}")


def ms_stats(v):
    return f"median {np.median(v):.2f}, max {np.max(v):.2f} ms ({len(v)} calls)"


def phase_nr_stack(smi):
    """Phase 21: the NR stack at 52 PRB (see NRS_PRB) on the card."""
    from srslte_tpu_torch import nr_worker
    from srslte_tpu_torch.mac.harq_nr import N_PROC_NR, NrDlHarqEntity
    from srslte_tpu_torch.phy.nr import NrPdcch, NrPdsch

    pkg = nr_stack_port("cuda")
    reset_counts()
    # 21a, HARQ: each per-slot call timed, the DCI search inside rx_slot apart
    times, search = {}, []
    t0 = time.perf_counter()
    with wrapped(((NrPdcch, "search", "dci_search"),), call_timer(search)):
        out = nr_stack_scenario("harq", pkg, stack_timer(times, []))
    wall = time.perf_counter() - t0
    nr_stack_gates("harq", out)
    search_ms = [ms for _, ms in search]
    rest = [a - b for a, b in zip(times["rx_slot"], search_ms)]
    print(f"[21a NR HARQ] {NRS_HARQ_TBS} TBs of {NRS_TBS} bits at {NRS_HARQ_SNR_DB} dB over "
          f"{out['slots']} slots in {wall:.1f} s: timeline {out['timeline']}; delivered at slots "
          f"{out['delivered_at']}; {out['n_retx']} retransmissions, dropped {out['dropped']}; "
          f"every TB delivered once, in order, equal to the bits sent; the timeline equal to the "
          f"JAX package's", flush=True)
    print(f"[21a NR HARQ] ms per slot on the host clock (each call synchronised): tx_slot "
          f"{ms_stats(times['tx_slot'])}; rx_slot's DCI search {ms_stats(search_ms)}; the rest "
          f"of rx_slot {ms_stats(rest)}; rx_ul_slot {ms_stats(times['rx_ul_slot'])}; {smi}",
          flush=True)
    # the 16 soft buffers of the UE's HARQ entity, each holding a first
    # transmission that does not decode
    common, _, _ = nr_stack_workers(pkg)
    cfg = NrPdsch(common.carrier, rnti=common.rnti, slot=0, grant=common.phy_grant(0)).cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ent = NrDlHarqEntity()
    for pid in range(N_PROC_NR):
        ack, _ = ent.rx(pid, 0, torch.randn(cfg.G, generator=gen, device="cuda"), cfg)
        check(not ack, "a soft buffer of random LLRs decoded")
    held = sum(p.state.numel() * p.state.element_size() for p in ent.procs)
    peak = torch.cuda.max_memory_allocated()
    print(f"[21a NR HARQ] {N_PROC_NR} soft buffers held ({cfg.seg.C} x {cfg.graph.n_full} "
          f"float32 each, {held / 1e6:.2f} MB): peak device memory {peak / 1e6:.1f} MB "
          f"({(peak - before) / 1e6:.1f} MB above what was allocated before), {smi}", flush=True)
    del ent

    # 21b, the stack, its host synchronisations counted per stage
    t0 = time.perf_counter()
    out, n_sync, per = count_syncs(
        lambda: nr_stack_scenario("stack", pkg),
        ((nr_worker.GnbNrWorker, "tx_slot", "tx_slot"), (NrPdcch, "search", "dci_search"),
         (nr_worker.UeNrWorker, "rx_slot", "rx_slot"),
         (nr_worker.GnbNrWorker, "rx_ul_slot", "rx_ul_slot")))
    wall = time.perf_counter() - t0
    nr_stack_gates("stack", out)
    print(f"[21b NR stack] {NRS_PACKETS} packets ciphered by NEA2 (one of {5 * NRS_TBS // 16} "
          f"bytes over several RLC segments) in {out['tbs_queued']} TBs at {NRS_STACK_SNR_DB} dB "
          f"over {out['slots']} slots in {wall:.1f} s: every packet once and in order, "
          f"pdcp.rx_next {NRS_PACKETS}; timeline {out['timeline']}; host synchronisations "
          f"{n_sync} = {n_sync / out['slots']:.2f} per slot, by stage {per} (rx_slot's include "
          f"its DCI search's)", flush=True)

    # 21c, the VNF split: the PNF's round trip to the VNF apart from its encode
    times = {}
    tx_ms = []
    with wrapped(((nr_worker.GnbNrWorker, "tx_slot", "tx_slot"),), call_timer(tx_ms)):
        out = nr_vnf_scenario(pkg, stack_timer(times, []))
    check(out["delivered"] == out["slots"] and out["acked"] == out["slots"]
          and out == NR_STACK_JAX["vnf"], f"21c VNF: {out}, the JAX package's "
                                           f"{NR_STACK_JAX['vnf']}")
    rtt = [a - b for a, (_, b) in zip(times["pnf.run_slot"], tx_ms)]
    print(f"[21c NR VNF] {out['slots']} slots over loopback UDP: every TB byte-equal at the UE "
          f"VNF and every ACK cleared its HARQ process; the PNF's round trip to the VNF (SF_IND "
          f"to TX.request, apart from tx_slot) {ms_stats(rtt)}; UePnf.run_slot "
          f"{ms_stats(times['ue_pnf.run_slot'])}", flush=True)
    counts = read_counts()
    print(f"[21 NR stack] CUDA kernel launches in phase 21: {counts} (LDPC and polar are plain "
          f"PyTorch)", flush=True)


def nb_impair(x, delay, cfo_hz, snr_db, seed):
    """tests/test_nbiot_ue.py:_impair on the host: x [n] complex64 with a CFO,
    AWGN at snr_db below the power of its nonzero samples and `delay`
    samples of noise before it."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x)
    n = np.arange(len(x))
    x = x * np.exp(2j * np.pi * cfo_hz * n / 1.92e6)
    p = np.mean(np.abs(x[np.abs(x) > 0]) ** 2)
    sigma = np.sqrt(p / 10 ** (snr_db / 10) / 2)
    noise = sigma * (rng.standard_normal(len(x) + delay)
                     + 1j * rng.standard_normal(len(x) + delay))
    out = noise.astype(np.complex64)
    out[delay:] += x.astype(np.complex64)
    return out


def nb_example_bits():
    """The NPDSCH bits examples/npdsch_enodeb.generate sends (seed 0)."""
    return np.random.default_rng(0).integers(0, 2, 144).astype(np.uint8)


def nb_example_score(out):
    """22a's counts: (cell found with the right id and frame position, MIB
    decoded, DCIs found, TBs whose CRC passed and equal the bits sent)."""
    if out is None:
        return (0, 0, 0, 0)
    cell = out["cell"]
    delay = NB_IMPAIR[0]
    cell_ok = int(cell["n_id"] == NB_ID and cell["frame_pos"] == 0
                  and (cell["sf0_offset"] - delay) % (20 * 1920) in (0, 1, 20 * 1920 - 1))
    mib_ok = int(out["mib"] is not None and out["mib"].sched_info_sib1 == 3
                 and out["mib"].sys_info_tag == 1 and out["mib"].op_mode == 2)
    bits = nb_example_bits()
    tb_ok = sum(int(r["crc_ok"] and np.array_equal(np.asarray(r["bits"], np.uint8), bits))
                for r in out["results"])
    return (cell_ok, mib_ok, len(out["results"]), tb_ok)


def nb_long_sf_nf():
    """The 10 (subframe, frame) pairs of 22b's grant: frames 2 and 3,
    skipping subframes 0 (NPBCH), 5 (NPSS) and 9 of even frames (NSSS)."""
    pairs = [(s, nf) for nf in (2, 3) for s in range(10)
             if s not in (0, 5) and not (s == 9 and nf % 2 == 0)]
    return tuple(pairs[:10])


def nb_long_samples(pkg, nof_ports, device):
    """22b's stimulus on the package `pkg` (`nb_port`, or the JAX package's
    in tests/rehearse_nbiot.py): NB_TBS TBs of NB_LONG, each NRS + NPDSCH on
    10 subframes through the NB-IoT OFDM modulator, the ports summed.
    Returns (bits [NB_TBS, tbs] uint8 numpy, samples [NB_TBS, 10, 1920]
    complex64 numpy)."""
    grant = pkg.NbDlGrant(*NB_LONG)
    rng = np.random.default_rng(NB_SEED + nof_ports)
    bits = rng.integers(0, 2, (NB_TBS, grant.tbs)).astype(np.uint8)
    sf_nf = nb_long_sf_nf()
    enb = pkg.NbEnbDl(NB_ID, nof_ports)
    npdsch = pkg.Npdsch(NB_ID, grant, NB_RNTI, nof_ports=nof_ports)
    nrs = [enb._put_nrs(pkg.zeros((2, 14, 12), device), s) for s, _ in sf_nf]
    out = []
    for b in bits:
        grids = npdsch.encode(pkg.asarray(b, device), nrs, sf_nf)
        s = pkg.NbOfdm().tx_sf(pkg.stack(grids))  # [10, 2, 1920]
        out.append(pkg.numpy(s[:, :nof_ports].sum(1)))
    return bits, np.stack(out).astype(np.complex64)


def nb_long_noisy(x, snr_db, seed):
    """x [B, 10, 1920] with AWGN snr_db below the mean power of its nonzero
    samples, drawn on the host from `seed`."""
    rng = np.random.default_rng(seed)
    p = np.mean(np.abs(x[np.abs(x) > 0]) ** 2)
    sigma = np.sqrt(p / 10 ** (snr_db / 10) / 2)
    n = sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return (x + n).astype(np.complex64)


def nb_port():
    """The port's NB-IoT classes for `nb_long_samples`."""
    from srslte_tpu_torch.phy.nbiot.npdsch import NbDlGrant, Npdsch
    from srslte_tpu_torch.phy.nbiot.ue import NbEnbDl, NbOfdm

    return types.SimpleNamespace(
        NbDlGrant=NbDlGrant, Npdsch=Npdsch, NbEnbDl=NbEnbDl, NbOfdm=NbOfdm,
        zeros=lambda shape, dev: torch.zeros(shape, dtype=torch.complex64, device=dev),
        asarray=lambda a, dev: torch.as_tensor(a, device=dev), stack=torch.stack,
        numpy=lambda t: t.cpu().numpy())


def nb_long_decode(x, nof_ports, device):
    """Decode each TB of 22b's samples x [B, 10, 1920] on the port: the UE's
    fft_estimate per subframe, then Npdsch(nof_ports=2).decode or, for 1
    port, UeDlNbiot.decode_npdsch.  Returns (bits [B, tbs], crc ok [B])."""
    from srslte_tpu_torch.phy.nbiot.npdsch import NbDlGrant, Npdsch
    from srslte_tpu_torch.phy.nbiot.ue import UeDlNbiot

    grant = NbDlGrant(*NB_LONG)
    sf_nf = nb_long_sf_nf()
    ue = UeDlNbiot(NB_ID)
    x = torch.as_tensor(x, device=device)
    bits, oks = [], []
    for b in range(x.shape[0]):
        est = [ue.fft_estimate(x[b, i], s) for i, (s, _) in enumerate(sf_nf)]
        grids = torch.stack([g for g, _, _ in est])
        ces = torch.stack([c for _, c, _ in est])
        if nof_ports == 2:
            out, ok = Npdsch(NB_ID, grant, NB_RNTI, nof_ports=2).decode(grids, ces, sf_nf)
        else:
            out, ok = ue.decode_npdsch(grids, ces, sf_nf, grant, NB_RNTI)
        bits.append(out)
        oks.append(ok)
    return torch.stack(bits).cpu().numpy(), torch.stack(oks).cpu().numpy()


def nb_stage_hooks():
    """The stages of the NB-IoT receiver, as (owner, attribute, name)."""
    from srslte_tpu_torch.phy.nbiot.npbch import Npbch
    from srslte_tpu_torch.phy.nbiot.npdsch import Npdsch
    from srslte_tpu_torch.phy.nbiot.ue import UeCellSearchNbiot, UeDlNbiot

    return ((UeCellSearchNbiot, "search", "cell_search"), (Npbch, "decode", "mib"),
            (UeDlNbiot, "search_npdcch", "dci_search"), (Npdsch, "decode", "npdsch_decode"))


def nb_stage_recorder(times, launches):
    """A `wrapped` wrap: each call synchronised and timed (ms into
    times[name]) and its Viterbi launches counted (into launches[name])."""
    from srslte_tpu_torch.ops import viterbi_cuda

    def wrap(fn, name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            n0 = viterbi_cuda.viterbi_decode.launches
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            launches[name] = launches.get(name, 0) + viterbi_cuda.viterbi_decode.launches - n0
            return out
        return call
    return wrap


def phase_nbiot(smi):
    """Phase 22: NB-IoT (see NB_ID) on the card.  Returns the kernel launch
    counts of the `nbiot` path (22a and 22b)."""
    from srslte_tpu_torch.examples import npdsch_enodeb, npdsch_ue

    reset_counts()
    # 22a: the example pair on the card, the capture impaired on the host
    t0 = time.perf_counter()
    sig = npdsch_enodeb.generate(NB_ID, NB_RNTI, NB_FRAMES, 5, 1, device="cuda")
    gen_s = time.perf_counter() - t0
    check(sig.shape == (NB_FRAMES * 19200,) and np.isfinite(sig).all(), "22a: capture")
    x = nb_impair(sig, *NB_IMPAIR)
    times, launches = {}, {}
    t0 = time.perf_counter()
    with wrapped(nb_stage_hooks(), nb_stage_recorder(times, launches)):
        out = npdsch_ue.receive(x, NB_RNTI, device="cuda")
    wall = time.perf_counter() - t0
    score = nb_example_score(out)
    want = NB_JAX["example"]
    check(all(g >= w for g, w in zip(score, want)),
          f"22a: (cell, MIB, DCIs, TBs equal to the bits sent) {score}, the JAX package's {want}")
    check(all(np.array_equal(r["bits"], nb_example_bits()) for r in out["results"] if r["crc_ok"]),
          "22a: a TB that passed its CRC differs from the bits sent")
    stages = "; ".join(f"{k} {ms_stats(v)}, {launches.get(k, 0)} Viterbi launches"
                       for k, v in times.items())
    print(f"[22a NB-IoT example pair] {NB_FRAMES} frames generated on the card in {gen_s:.2f} s, "
          f"delay {NB_IMPAIR[0]}, CFO {NB_IMPAIR[1]} Hz, {NB_IMPAIR[2]} dB; receive in "
          f"{wall:.2f} s: (cell, MIB, DCIs, TBs) {score} (the JAX package's {want}); cell "
          f"{out['cell']['n_id']}, CFO {out['cell']['cfo_hz']:.1f} Hz; stages: {stages}; {smi}",
          flush=True)

    # 22b: the longest grant, 2 ports and 1
    for nof_ports in (2, 1):
        t0 = time.perf_counter()
        bits, x = nb_long_samples(nb_port(), nof_ports, "cuda")
        enc_s = time.perf_counter() - t0
        for name, xi in (("clean", x), (f"{NB_SNR_DB[nof_ports]} dB",
                                        nb_long_noisy(x, NB_SNR_DB[nof_ports], NB_SEED))):
            times, launches = {}, {}
            with wrapped(nb_stage_hooks(), nb_stage_recorder(times, launches)):
                got, ok = nb_long_decode(xi, nof_ports, "cuda")
            n_ok = int(ok.sum())
            check(all(np.array_equal(g, b) for g, b, o in zip(got, bits, ok) if o),
                  f"22b {nof_ports} port(s), {name}: a TB that passed its CRC differs")
            lost = tuple(np.flatnonzero(~ok).tolist())
            want = NB_JAX[f"long{nof_ports}"][0 if name == "clean" else 1]
            check(set(lost) <= set(want), f"22b {nof_ports} port(s), {name}: TBs {lost} lost, "
                                          f"the JAX package loses {want}")
            print(f"[22b NB-IoT TBS 680 over 10 subframes, {nof_ports} port(s), {name}] "
                  f"{n_ok}/{NB_TBS} TBs, lost {lost} (the JAX package loses {want}), each "
                  f"decoded TB equal to the bits sent; "
                  f"NPDSCH decode {ms_stats(times['npdsch_decode'])}, "
                  f"{launches['npdsch_decode']} Viterbi launches of [1, 704]; stimulus built on "
                  f"the card in {enc_s:.2f} s; {smi}", flush=True)
    return read_counts()


# ------------------------------------------------------------ the sidelink
def sl_pssch(sf_idx, prb_start=SL_ALLOC[0], n_prb=SL_ALLOC[1], n_x_id=SL_ID, mcs=SL_MCS):
    from srslte_tpu_torch.phy.sidelink import Pssch

    return Pssch(SL_PRB, prb_start, n_prb, n_x_id=n_x_id, sf_idx=int(sf_idx), mcs=mcs)


def sl_sci():
    from srslte_tpu_torch.phy.phch.ra import riv_type2
    from srslte_tpu_torch.phy.sidelink import Sci0

    return Sci0(riv=riv_type2(SL_PRB, *SL_ALLOC), mcs=SL_MCS, group_dst_id=SL_ID)


def sl_sigma(snr_db):
    """AWGN per component for snr_db per RE over the received data power."""
    return abs(SL_H) * 10 ** (-snr_db / 20) / math.sqrt(2)


def sl_channel(grids, sigma, seed):
    """The flat channel SL_H and AWGN of `sigma` per component (none for
    None) drawn on the host from `seed`: grids (tensor) -> numpy complex64."""
    x = grids.cpu().numpy() * SL_H
    if sigma is not None:
        rng = np.random.default_rng(seed)
        x = x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def sl_sync_grid(n_sl_id, device="cuda"):
    """A sync subframe [14, SL_PRB * 12]: PSSS in symbols 1-2, SSSS in
    11-12 (the centre 62 subcarriers), the PSBCH with SL_MIB and its DMRS
    in the centre 6 PRB."""
    from srslte_tpu_torch.phy.sidelink import MibSl, Psbch, psss_sequence, ssss_sequence
    from srslte_tpu_torch.phy.sidelink.common import PSSS_SYMS, SSSS_SYMS

    grid = Psbch(n_sl_id, SL_PRB).encode(
        MibSl(**SL_MIB), torch.zeros((14, SL_PRB * 12), dtype=torch.complex64, device=device))
    mid = SL_PRB * 6
    for syms, seq in ((PSSS_SYMS, psss_sequence(n_sl_id // 168)),
                      (SSSS_SYMS, ssss_sequence(n_sl_id).astype(np.complex64))):
        grid[list(syms), mid - 31 : mid + 31] = torch.as_tensor(seq, device=device)
    return grid


def sl_sync_receive(rx):
    """The blind receive of a sync subframe: PSSS -> N_id_2, the SSSS
    coherently through the PSSS's channel -> N_SL_ID, the PSBCH of that id
    -> (id, CRC ok, MIB-SL)."""
    from srslte_tpu_torch.phy.sidelink import Psbch, psss_detect, psss_sequence, ssss_detect
    from srslte_tpu_torch.phy.sidelink.common import PSSS_SYMS, SSSS_SYMS

    mid = SL_PRB * 6
    p = rx[PSSS_SYMS[0], mid - 31 : mid + 31]
    id2, _ = psss_detect(p)
    href = p * torch.conj(torch.as_tensor(psss_sequence(id2), device=rx.device))
    n_sl_id, _ = ssss_detect(rx[SSSS_SYMS[0], mid - 31 : mid + 31], href)
    ok, mib = Psbch(n_sl_id, SL_PRB).decode(rx)
    return n_sl_id, ok, mib


def sl_stimulus(name, device="cuda"):
    """Phase 23's data subframes (`name` "sf": sf_idx = i mod 10, 23b;
    "batch": all SL_BATCH_SF_IDX, 23c): (sf indices [SL_N], bits [SL_N,
    tbs] uint8, grids [SL_N, 14, SL_PRB * 12]), the SCI-0 on the PSCCH and
    its PSSCH in each, encoded on `device`."""
    from srslte_tpu_torch.phy.sidelink import Pscch

    sfs = np.arange(SL_N) % 10 if name == "sf" else np.full(SL_N, SL_BATCH_SF_IDX)
    base = Pscch(SL_PRB, *SL_PSCCH).encode(
        sl_sci(), torch.zeros((14, SL_PRB * 12), dtype=torch.complex64, device=device))
    rng = np.random.default_rng(SL_SEEDS[name])
    bits = torch.as_tensor(rng.integers(0, 2, (SL_N, sl_pssch(0).tbs), dtype=np.uint8),
                           device=device)
    grids = torch.empty((SL_N, 14, SL_PRB * 12), dtype=torch.complex64, device=device)
    for s in np.unique(sfs):
        sel = torch.as_tensor(np.flatnonzero(sfs == s), device=device)
        grids[sel] = sl_pssch(s).encode(bits[sel], base)
    return sfs, bits, grids


def sl_receive(rx, sf_idx):
    """One subframe as test_sidelink_control_data_flow receives it: the
    SCI-0 from the PSCCH, then the PSSCH it describes -> (SCI or None,
    bits [tbs] or None, CRC ok tensor or False)."""
    from srslte_tpu_torch.phy.phch.ra import riv_type2_decode
    from srslte_tpu_torch.phy.sidelink import Pscch

    sci = Pscch(SL_PRB, *SL_PSCCH).decode(rx)
    if sci is None:
        return None, None, False
    rb0, l_rb = riv_type2_decode(SL_PRB, sci.riv)
    out, ok = sl_pssch(sf_idx, rb0, l_rb, sci.group_dst_id, sci.mcs).decode(rx)
    return sci, out, ok


def sl_gates(ok, label, jax_lost):
    """Clean: every TB; at SL_SNR_DB: >= 80 % and every lost TB among the
    JAX package's (`jax_lost`).  Returns the lost TBs."""
    lost = tuple(np.flatnonzero(~ok).tolist())
    if jax_lost is None:
        check(not lost, f"{label}: TBs {lost} lost on the clean channel")
    else:
        check(ok.mean() >= 0.8 and set(lost) <= set(jax_lost),
              f"{label}: {int(ok.sum())}/{len(ok)} TBs, lost {lost}, the JAX package loses "
              f"{jax_lost}")
    return lost


def phase_sidelink(smi):
    """Phase 23: sidelink TM1/2 at 50 PRB (see SL_PRB) on the card.  Returns
    the kernel launch counts of the phase (the `sidelink` path)."""
    from srslte_tpu_torch.phy.sidelink import MibSl, Pscch

    check((sl_pssch(0).tbs, sl_pssch(0).cfg.G, sl_pssch(0).cfg.seg.C, sl_pssch(0).cfg.seg.K1)
          == SL_BUCKET, "unexpected PSSCH bucket")
    by_shape = collections.Counter()
    reset_counts()
    with launch_shapes(by_shape):
        # 23a: the sync subframe of each id
        sync_ms = []
        for i, n in enumerate(SL_SYNC_IDS):
            rx = torch.as_tensor(sl_channel(sl_sync_grid(n), SL_SYNC_NOISE, 500 + i), device="cuda")
            (got, ok, mib), ms, _ = timed(lambda: sl_sync_receive(rx))
            sync_ms.append(ms)
            check(got == n and ok and mib == MibSl(**SL_MIB),
                  f"23a: N_SL_ID {n} read as {got}, PSBCH CRC {ok}, {mib}")
        print(f"[23a sidelink sync] N_SL_ID {SL_SYNC_IDS} each found from the PSSS and the "
              f"coherent SSSS, and the MIB-SL {SL_MIB} read from the PSBCH in the centre 6 PRB of "
              f"a {SL_PRB} PRB grid (noise {SL_SYNC_NOISE} per component); ms per sync receive "
              f"{', '.join(f'{v:.2f}' for v in sync_ms)} (the first builds the tables)",
              flush=True)

        # 23b: per subframe, the UE's receive; then noise alone on the PSCCH
        sfs, bits, grids = sl_stimulus("sf")
        host_bits = bits.cpu().numpy()
        for label, snr in (("clean", None), (f"{SL_SNR_DB:g} dB", SL_SNR_DB)):
            rx = torch.as_tensor(sl_channel(grids, None if snr is None else sl_sigma(snr),
                                            SL_SEEDS["sf"] + 1000), device="cuda")
            calls, data_ms, outs = [], [], []
            with wrapped(((Pscch, "decode", "sci"),), call_timer(calls)):
                for i in range(SL_N):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sci, out, ok = sl_receive(rx[i], sfs[i])
                    torch.cuda.synchronize()
                    data_ms.append((time.perf_counter() - t0) * 1e3 - calls[-1][1])
                    check(sci == sl_sci(), f"23b {label}: subframe {i}: SCI {sci}")
                    outs.append((out, ok))
            sci_ms = [ms for _, ms in calls]
            ok = torch.stack([o for _, o in outs]).cpu().numpy()
            got = torch.stack([b for b, _ in outs]).cpu().numpy()
            ok &= (got == host_bits).all(-1)
            lost = sl_gates(ok, f"23b {label}", None if snr is None else SL_JAX["sf"])
            print(f"[23b sidelink per subframe, {label}] {SL_N} subframes (sf_idx i mod 10): "
                  f"every SCI-0 right, {int(ok.sum())}/{SL_N} TBs of {SL_BUCKET[0]} bits equal to "
                  f"the bits sent, lost {lost} (the JAX package's {SL_JAX['sf']} at "
                  f"{SL_SNR_DB:g} dB); ms per subframe: the PSCCH decode {ms_stats(sci_ms)}, "
                  f"the PSSCH decode {ms_stats(data_ms)}; {smi}", flush=True)
        rng = np.random.default_rng(SL_SEEDS["sf"] + 2000)
        noise = torch.as_tensor((rng.standard_normal((SL_NOISE_ONLY, 14, SL_PRB * 12, 2)) / math.sqrt(2))
                                .astype(np.float32), device="cuda")
        false = [Pscch(SL_PRB, *SL_PSCCH).decode(torch.view_as_complex(g)) for g in noise]
        check(all(f is None for f in false), f"23b: an SCI from noise alone: {false}")
        print(f"[23b sidelink] {SL_NOISE_ONLY} grids of noise alone through Pscch.decode: no SCI",
              flush=True)

        # 23c: one batched dispatch of SL_N subframes of one sf_idx
        _, bits, grids = sl_stimulus("batch")
        host_bits = bits.cpu().numpy()
        p = sl_pssch(SL_BATCH_SF_IDX)
        for label, snr in (("clean", None), (f"{SL_SNR_DB:g} dB", SL_SNR_DB)):
            rx = torch.as_tensor(sl_channel(grids, None if snr is None else sl_sigma(snr),
                                            SL_SEEDS["batch"] + 1000), device="cuda")
            ms, (out, ok) = median_ms(lambda: p.decode(rx))
            ok = ok.cpu().numpy() & (out.cpu().numpy() == host_bits).all(-1)
            lost = sl_gates(ok, f"23c {label}", None if snr is None else SL_JAX["batch"])
            print(f"[23c sidelink batched, {label}] {SL_N} subframes (sf_idx {SL_BATCH_SF_IDX}) "
                  f"through one Pssch.decode: {int(ok.sum())}/{SL_N} TBs, lost {lost} (the JAX "
                  f"package's {SL_JAX['batch']} at {SL_SNR_DB:g} dB); {ms:.3f} ms per dispatch "
                  f"(median of {N_TIMED}) = {SL_N / ms * 1e3:.1f} subframes/s = "
                  f"{SL_N / ms:.2f} x real time; {smi}", flush=True)
    counts = read_counts()
    per = sorted(by_shape.items(), key=lambda kv: -kv[1])
    print(f"[23 sidelink] kernel launches {counts}; by shape: "
          + "; ".join(f"{k} {shp}: {n}" for (k, shp), n in per), flush=True)
    return counts


# ------------------------------------------------------------ scale-out
def scale_fading(x, seed):
    """tests/test_time_shard.py:_fading on the host: SCALE_TAPS over the
    samples of each subframe [n, sf_len], AWGN of SCALE_NOISE per component
    from `seed`."""
    rng = np.random.default_rng(seed)
    y = np.zeros_like(x)
    for d, t in enumerate(SCALE_TAPS):
        y[..., d:] += t * x[..., : x.shape[-1] - d]
    y = y + SCALE_NOISE * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    return y.astype(np.complex64)


def scale_time_stimulus(device="cuda"):
    """24b's chain and stimulus: (chain, bits [SL_N, tbs] uint8 on the
    device, faded samples [SL_N, sf_len] numpy)."""
    from srslte_tpu_torch.parallel.time_shard import TimeShardedDlChain
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.phy.phch.ra import DlGrant

    chain = TimeShardedDlChain(Cell(n_prb=100, id=3, nof_ports=1), DlGrant.full(100, 27))
    rng = np.random.default_rng(SCALE_SEED + 1)
    bits = torch.as_tensor(rng.integers(0, 2, (SL_N, chain.tbs), dtype=np.uint8), device=device)
    return chain, bits, scale_fading(chain.encode(bits).cpu().numpy(), SCALE_SEED + 2)


def phase_scale_out(smi):
    """Phase 24: the scale-out modules on SCALE_SHARDS virtual shards of the
    one card (see SCALE_SHARDS).  Returns the kernel launch counts of 24a's
    sharded step and of 24b's 8-shard receive."""
    from srslte_tpu_torch.parallel import ShardedDlPipeline, make_mesh, sharded_pss_search
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.phy.phch.ra import DlGrant
    from srslte_tpu_torch.phy.sync.pss import pss_find_peak, pss_time

    cuda0 = torch.device("cuda", 0)
    siso_only = ("siso_windowed", "siso_windowed_bf16")
    counts = {}

    # 24a: the carrier axis
    mesh = make_mesh({"carrier": SCALE_SHARDS}, [cuda0] * SCALE_SHARDS)
    pipe = ShardedDlPipeline(Cell(n_prb=100, id=1, nof_ports=1), DlGrant.full(100, 27))
    check(pipe.tbs == DL_BUCKETS[27][0], "24a: unexpected TBS")
    rng = np.random.default_rng(SCALE_SEED)
    bits = torch.as_tensor(rng.integers(0, 2, (SCALE_SHARDS, SCALE_SF, pipe.tbs), dtype=np.uint8),
                           device=cuda0)
    step = pipe.jit_e2e(mesh)
    by_shape = collections.Counter()
    reset_counts()
    with launch_shapes(by_shape, siso_only):
        out_s, ok_s, bler_s = step(bits)
        torch.cuda.synchronize()
    counts["scale_carrier"] = read_counts()
    out_1, ok_1, bler_1 = pipe.e2e(bits)
    check(bool(ok_s.all()) and float(bler_s) == 0.0 and torch.equal(out_s, bits),
          f"24a: {int(ok_s.sum())}/{ok_s.numel()} TBs, BLER {float(bler_s)}")
    check(torch.equal(out_s, out_1) and torch.equal(ok_s, ok_1) and float(bler_1) == 0.0,
          "24a: the sharded step differs from the unsharded e2e")
    ms_s, _ = median_ms(lambda: step(bits), 5)
    ms_1, _ = median_ms(lambda: pipe.e2e(bits), 5)
    n = SCALE_SHARDS * SCALE_SF
    print(f"[24a scale-out, carriers] {SCALE_SHARDS} carriers x {SCALE_SF} subframes over "
          f"{SCALE_SHARDS} virtual shards of the one card: every TB right, BLER 0, bits and flags "
          f"equal to the unsharded e2e; ms per step (encode + decode, median of 5): sharded "
          f"{ms_s:.3f}, unsharded {ms_1:.3f} ({n} subframes); SISO launches of the sharded step "
          f"by shape: " + "; ".join(f"{shp}: {k}" for (_, shp), k in by_shape.items())
          + f"; {smi}", flush=True)
    del out_s, out_1, bits

    # 24b: the time axis with the chest halo
    chain, bits, x = scale_time_stimulus()
    rx = torch.as_tensor(x, device=cuda0)
    ms_1, (b_ref, ok_ref) = median_ms(lambda: chain.rx(rx), 5)
    n_ok = int((ok_ref & (b_ref == bits).all(-1)).sum())
    check(n_ok >= SCALE_JAX_TIME_OK, f"24b: {n_ok} TBs, the JAX package's rx {SCALE_JAX_TIME_OK}")
    sf_mod = torch.as_tensor(np.arange(SL_N) % 10, device=cuda0)
    h_full = chain._ls_freq(chain._ofdm.rx_sf(rx), sf_mod)
    ce_ref = chain._smooth(h_full, h_full[0], True)
    times = {}
    for n_dev in (2, SCALE_SHARDS):
        m = make_mesh({"t": n_dev}, [cuda0] * n_dev)
        by_shape = collections.Counter()
        if n_dev == SCALE_SHARDS:
            reset_counts()
        with launch_shapes(by_shape, siso_only):
            b_sh, ok_sh = chain.rx_sharded(rx, m)
            torch.cuda.synchronize()
        if n_dev == SCALE_SHARDS:
            counts["scale_time"] = read_counts()
        check(torch.equal(b_sh, b_ref) and torch.equal(ok_sh, ok_ref),
              f"24b: {n_dev} shards: bits or CRC flags differ from rx")
        ce = chain.ce_sharded(rx, m)
        starts = range(SL_N // n_dev, SL_N, SL_N // n_dev)
        check(torch.equal(ce, ce_ref) and all(not torch.equal(ce[s], h_full[s]) for s in starts),
              f"24b: {n_dev} shards: the CE differs from rx's, or a block start self-primes")
        times[n_dev], _ = median_ms(lambda: chain.rx_sharded(rx, m), 5)
        shapes = "; ".join(f"{shp}: {k}" for (_, shp), k in by_shape.items())
        print(f"[24b scale-out, time, {n_dev} shards] bits, CRC flags and the CE equal to the "
              f"unsharded rx's; every block start's CE differs from its own LS (the halo carries "
              f"state); SISO launches by shape: {shapes}", flush=True)
    print(f"[24b scale-out, time] {SL_N} subframes through the 3-tap channel (noise "
          f"{SCALE_NOISE}): {n_ok}/{SL_N} TBs (the JAX package's rx {SCALE_JAX_TIME_OK}); ms per "
          f"receive (median of 5): unsharded {ms_1:.3f}, 2 shards {times[2]:.3f}, "
          f"{SCALE_SHARDS} shards {times[SCALE_SHARDS]:.3f}; {smi}", flush=True)
    del rx, b_ref, b_sh, h_full, ce, ce_ref

    # 24c: the PSS search over a 20 MHz stream
    fft = 2048
    n = SL_N * 30720
    m = make_mesh({"t": SCALE_SHARDS}, [cuda0] * SCALE_SHARDS)
    rng = np.random.default_rng(SCALE_SEED + 3)
    for delay, nid2 in SCALE_PSS:
        x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        x[delay : delay + fft] += 3.0 * pss_time(nid2, fft)
        x = torch.as_tensor(x.astype(np.complex64), device=cuda0)
        ms_s, (g_n, g_off, g_m) = median_ms(lambda: sharded_pss_search(x, fft, m), 5)
        ms_1, (u_n, u_off, _) = median_ms(lambda: pss_find_peak(x, fft), 5)
        g_n, g_off, u_n, u_off = int(g_n), int(g_off), int(u_n), int(u_off)
        check(g_n == u_n == nid2 and abs(g_off - delay) <= 1 and abs(g_off - u_off) <= 1,
              f"24c: PSS {nid2} at {delay}: sharded ({g_n}, {g_off}), unsharded ({u_n}, {u_off})")
        where = ("60 samples before a shard boundary" if (delay + 60) % (n // SCALE_SHARDS) == 0
                 else "inside a shard")
        print(f"[24c scale-out, PSS search] {n} samples (fft {fft}) over {SCALE_SHARDS} shards, "
              f"N_id_2 {nid2} at sample {delay} ({where}): found ({g_n}, {g_off}, metric "
              f"{float(g_m):.3f}), unsharded ({u_n}, {u_off}); ms per search (median of 5): "
              f"sharded {ms_s:.3f}, unsharded {ms_1:.3f}; {smi}", flush=True)
    return counts


# ------------------------------------------------------------ the scripts
def spawn_reader(args):
    """A process of `python -u -m args...` from the repo root, its output
    lines in a queue filled by a thread."""
    import queue
    import threading

    p = subprocess.Popen([sys.executable, "-u", "-m", *map(str, args)],
                         cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    q = queue.Queue()
    threading.Thread(target=lambda: [q.put(line) for line in p.stdout], daemon=True).start()
    return p, q


def read_until(q, prefix, deadline, log):
    """The first line of q that starts with prefix, before `deadline`
    (time.time()); every line read goes to log.  The limit is a failure."""
    import queue

    while True:
        left = deadline - time.time()
        check(left > 0, f"25b: no line starting {prefix!r} within the limit; output {log}")
        try:
            line = q.get(timeout=left).rstrip()
        except queue.Empty:
            continue
        log.append(line)
        if line.startswith(prefix):
            return line


def phase_scripts(capture, smi):
    """Phase 25: the JAX package's remaining entry points, ported: 25a the
    cell scanner on phase 12's capture; 25b run_epc, run_enb and run_ue as
    three processes on the card."""
    from srslte_tpu_torch.examples.cell_search import scan

    a, _, cell, _, mib = capture
    scan(a[: cell.ofdm.sf_len * 20], BLIND_PRB)  # the tables built and uploaded
    got, ms, peak = timed(lambda: scan(a, BLIND_PRB))
    check(got is not None and got["cell_id"] == cell.id and got.get("mib") == mib
          and got["nof_ports"] == cell.nof_ports, f"25a: scan found {got}, phase 12 read {mib}")
    print(f"[25a cell_search.scan] phase 12's capture ({len(a)} samples, {BLIND_PRB} PRB): PCI "
          f"{got['cell_id']}, CFO {got['cfo_sc']:.4f} subcarriers, votes {got['votes']}, "
          f"{got['mib']} on {got['nof_ports']} port, the MIB phase 12's receive read; {ms:.1f} "
          f"ms, peak {peak}; {smi}", flush=True)

    procs, logs, starts = [], {"epc": [], "enb": [], "ue": []}, []

    def spawn(module, *args):
        starts.append(time.time())
        procs.append(spawn_reader((f"srslte_tpu_torch.examples.{module}", *args)))
        return procs[-1][1]

    def deadline():
        """Every process started so far is held to SCRIPT_LIMIT_S."""
        return min(starts) + SCRIPT_LIMIT_S

    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "s1_port")
        try:
            dl, ul = SCRIPT_PORTS
            read_until(spawn("run_epc", port_file), "EPC ready", deadline(), logs["epc"])
            s1_port = int(open(port_file).read())
            read_until(spawn("run_enb", s1_port, dl, ul), "ENB ready", deadline(), logs["enb"])
            ue = spawn("run_ue", dl, ul)
            read_until(ue, "UE ready", deadline(), logs["ue"])
            attached = read_until(ue, "ATTACHED", deadline(), logs["ue"])
            t_att = time.time()
            echo = read_until(ue, "DL_DATA", deadline(), logs["ue"])
            t_end = time.time()
            check(echo == "DL_DATA echo:ping-3proc", f"25b: the UE printed {echo!r}")
        finally:
            for p, _ in procs:
                p.kill()
            for p, _ in procs:
                p.wait(timeout=30)
    t0, t_ue = starts[0], starts[2]
    print(f"[25b run_epc + run_enb + run_ue] three processes (the eNB and the UE on the card, "
          f"15 PRB, the UDP sample pipe, S1AP over framed TCP): UE {attached!r}, then "
          f"{echo!r}; wall from the UE's start: attach {t_att - t_ue:.1f} s, echo "
          f"{t_end - t_ue:.1f} s; from the EPC's start {t_end - t0:.1f} s; {smi}", flush=True)


# ------------------------------------------------- one dispatch per call
GRAPH_FLOAT_TOL = 1e-5  # a float output's largest difference from the eager run, of its scale


def tree_clone(x):
    from torch.utils._pytree import tree_map

    return tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor) else v, x)


def first_calls(run):
    """{entry point: (wrapped function, args, kwargs)} of the first call of
    each entry point that run() makes outside a graph, its tensors cloned."""
    from srslte_tpu_torch.utils import jit

    with jit.recording_calls() as calls:
        run()
    first = {}
    for fn, args, kwargs in calls:
        name = fn.jit_site.name.removeprefix("srslte_tpu_torch.")
        if name not in first:
            first[name] = (fn, tree_clone(args), tree_clone(kwargs))
    torch.cuda.synchronize()
    return first


def graph_diff(g, e):
    """(integer and bool outputs equal, the largest float difference, the
    largest over the output's scale) of a graphed call's outputs g against
    the eager call's e."""
    from torch.utils._pytree import tree_leaves

    lg, le = tree_leaves(g), tree_leaves(e)
    check(len(lg) == len(le), "graphed and eager outputs differ in structure")
    hard, diff, rel = True, 0.0, 0.0
    for a, b in zip(lg, le):
        if not isinstance(a, torch.Tensor):
            hard = hard and a == b
        elif a.is_floating_point() or a.is_complex():
            d = float((a - b).abs().max()) if a.numel() else 0.0
            diff = max(diff, d)
            rel = max(rel, d / max(float(b.abs().max()) if b.numel() else 0.0, 1e-30))
        else:
            hard = hard and a.shape == b.shape and torch.equal(a, b)
    return hard, diff, rel


def same_tree(a, b):
    """Two trees (arguments or outputs) equal leaf by leaf, tensors bit for
    bit."""
    from torch.utils._pytree import tree_leaves

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        if isinstance(x, np.ndarray):
            return np.array_equal(x, y)
        return x is y or x == y

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(same(x, y) for x, y in zip(la, lb))


def siso_branch(by_shape):
    """The SISO launches of a call by shape, as "n x B=.. K=..", in order."""
    return ", ".join(f"{n} x {k[1].split(' L=')[0]}" for k, n in sorted(by_shape.items())
                     if k[0].startswith("siso"))


def graph_path(label, draws, smi):
    """Phase 26 for one path: `draws` are functions (or (name, function)
    pairs), each running the path once on its own input draw (the first
    captures the path's graphs, the others replay them).  For every entry
    point the path called, on every draw: one graph replay per call, hard
    outputs equal to the eager run's (`__wrapped__`) and floats within
    GRAPH_FLOAT_TOL of their scale, the kernel launches by shape equal to
    the eager run's (the conditional bodies the replay ran folded in), and
    every traced argument unchanged by either call; then, on the second
    draw, ms per call graphed and eager (median of N_TIMED) and the kernels
    and copies per call on the card (torch.profiler) graphed and eager.
    Returns {draw name: {entry point: SISO launches by shape}}."""
    from srslte_tpu_torch.utils import jit

    draws = [d if isinstance(d, tuple) else (f"draw {i + 1}", d) for i, d in enumerate(draws)]
    s0 = dict(jit.STATS)
    t0 = time.perf_counter()
    calls = [first_calls(d) for _, d in draws]
    wall = time.perf_counter() - t0
    s1, sites1, cache = dict(jit.STATS), jit.graphs(by_site=True), jit.graphs()
    print(f"[26 {label}] the {len(draws)} draws through the path: {wall:.2f} s, "
          f"{s1['captures'] - s0['captures']} captures ({s1['conds'] - s0['conds']} conds) in "
          f"{s1['capture_ms'] - s0['capture_ms']:.1f} ms, the graph pool grew "
          f"{s1['pool_mb'] - s0['pool_mb']:.1f} MB (to {s1['pool_mb']:.1f}); graphs in the "
          f"cache {cache['count']}, holding {cache['mb']:.1f} MB of static inputs and outputs",
          flush=True)
    branches = {name: {} for name, _ in draws}
    for name in calls[0]:
        worst, outs = (0.0, 0.0), []
        for (draw, _), c in zip(draws, calls):
            check(name in c, f"26 {label}: {name} not called in {draw}")
            fn, args, kw = c[name]
            before = tree_clone((args, kw))
            r0 = jit.STATS["replays"]
            g, g_shapes = counted_shapes(lambda: fn(*args, **kw))
            replays = jit.STATS["replays"] - r0
            check(same_tree((args, kw), before), f"26 {label}: {name}: the graphed call "
                                                 f"changed an argument ({draw})")
            e, e_shapes = counted_shapes(lambda: fn.__wrapped__(*args, **kw))
            check(same_tree((args, kw), before), f"26 {label}: {name}: the eager call changed "
                                                 f"an argument ({draw})")
            check(replays == 1, f"26 {label}: {name}: {replays} graph replays in one call")
            hard, diff, rel = graph_diff(g, e)
            check(hard, f"26 {label}: {name}: graphed and eager hard outputs differ ({draw})")
            check(rel <= GRAPH_FLOAT_TOL, f"26 {label}: {name}: float outputs differ by "
                                          f"{diff} ({rel} of their scale; {draw})")
            check(g_shapes == e_shapes, f"26 {label}: {name}: launches replayed "
                                        f"{dict(g_shapes)}, eager {dict(e_shapes)} ({draw})")
            branches[draw][name] = g_shapes
            worst = max(worst, (rel, diff))
            outs.append(g)
        fn, args, kw = calls[1][name]
        ms_g, _ = median_ms(lambda: fn(*args, **kw))
        ms_e, _ = median_ms(lambda: fn.__wrapped__(*args, **kw))
        k_g, busy_g = profiled(lambda: fn(*args, **kw))
        k_e, busy_e = profiled(lambda: fn.__wrapped__(*args, **kw))
        site = sites1.get(fn.jit_site.name, {"count": 0, "capture_ms": 0.0, "mb": 0.0})
        sisos = "; ".join(f"{draw} {siso_branch(b[name])}" for draw, b in branches.items()
                          if siso_branch(b[name]))
        print(f"[26 {label}] {name}: every draw 1 graph replay per call, equal to __wrapped__ "
              f"(hard outputs bit for bit, floats within {worst[1]:.3g} = {worst[0]:.3g} of "
              f"their scale; the draws' outputs "
              f"{'equal' if all(same_tree(outs[0], o) for o in outs) else 'differ'}), its "
              f"launches by shape the eager run's, its arguments unchanged; ms per call graphed "
              f"{ms_g:.3f}, eager {ms_e:.3f}; {k_e} eager kernels and copies ({k_g} graphed, "
              f"device busy {busy_g:.3f} ms graphed, {busy_e:.3f} ms eager); graphs "
              f"{site['count']}, captured in {site['capture_ms']:.1f} ms, holding "
              f"{site['mb']:.1f} MB{'; SISO launches: ' + sisos if sisos else ''}; {smi}",
              flush=True)
    return branches


def eviction_check(label, fn, args, kw, smi):
    """The graph cache lowered to GRAPH_BYTES = 1 while the entry point
    `fn` captures a new key (half the batch of `args`' first tensor): every
    other graph is evicted (its bodies folded, its sequences unpinned, its
    graph reset); then `fn` on `args` (its graph evicted: captured again)
    and on the half batch (replayed), each equal to `__wrapped__`."""
    from srslte_tpu_torch import _device
    from srslte_tpu_torch.utils import jit

    half = list(args)
    i = next(j for j, a in enumerate(half) if isinstance(a, torch.Tensor))
    half[i] = half[i][: half[i].shape[0] // 2].clone()
    n0, s0 = jit.graphs()["count"], dict(jit.STATS)
    saved = jit.GRAPH_BYTES
    jit.GRAPH_BYTES = 1
    try:
        fn(*half, **kw)
        torch.cuda.synchronize()
    finally:
        jit.GRAPH_BYTES = saved
    (g1,) = jit._GRAPHS.values()
    check(set(_device._PINS) == set(g1.pinned), "26 eviction: an evicted graph kept its pins")
    for a in (args, half):
        check(graph_diff(fn(*a, **kw), fn.__wrapped__(*a, **kw))[0],
              f"26 {label}: after the eviction a graphed call differs from __wrapped__")
    s1 = dict(jit.STATS)
    print(f"[26 eviction] {label}: GRAPH_BYTES lowered to 1 for one capture of half the batch: "
          f"{n0} graphs evicted, every pin but the new graph's released; the full batch "
          f"captured again and replayed, the half batch replayed, each equal to __wrapped__ "
          f"bit for bit ({s1['captures'] - s0['captures']} captures, {s1['replays'] - s0['replays']} "
          f"replays); {smi}", flush=True)


def profiled(run):
    """(kernels and copies on the card, device busy ms) of one run() under
    torch.profiler; (0, 0.0) where the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(k.self_device_time_total, k.count) for k in prof.key_averages()
            if k.device_type == DeviceType.CUDA and k.self_device_time_total > 0]
    return sum(n for _, n in rows), sum(us for us, _ in rows) / 1e3


def blind_draw(a, fft_size, seed):
    """Phase 12's stream B drawn with another noise seed."""
    return lambda: blind_receive(blind_impaired(a, fft_size, seed))


def phase_graphs(smi, capture=None):
    """Phase 26: one dispatch per call.  Every entry point the JAX package
    jits, on its path at the path's full width (graph_path): phase 5's DL
    (fft_estimate, the PDCCH decoders, Pdsch.decode), phases 13-14's SM
    (encode2 and decode2 at 2 and 4 ports), phase 15's PMCH, 20a's NR PDSCH
    (encode, demod_llr, decode), phase 12's blind receiver (cell search,
    sync_find, the tracker, the MIB's front and PBCH, the DL), phase 17's
    IntraMeasure and 22a's NPBCH."""
    from srslte_tpu_torch.examples import npdsch_enodeb, npdsch_ue
    from srslte_tpu_torch.phy.channel import awgn
    from srslte_tpu_torch.phy.common.params import CP, Cell
    from srslte_tpu_torch.phy.enb.enb_dl import EnbDl
    from srslte_tpu_torch.phy.ofdm import Ofdm
    from srslte_tpu_torch.phy.phch.pmch import Pmch
    from srslte_tpu_torch.phy.ue.intra_measure import IntraMeasure

    def cuda_gen(seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return gen

    chain = Chain()
    _, s = chain.encode(seed=31)

    def dl(seed, snr_db=SNR_DB):
        def run():
            rx = UlChain.noisy(s, snr_db, cuda_gen(seed))
            grid, ce, _ = chain.ue.fft_estimate(rx, SF_IDX)
            chain.pd.decode_candidates(grid, ce, chain.groups[-1], chain.dci_len, RNTI)
            chain.receive(rx)
        return run
    # two draws at 16 dB; a clean one, whose blocks all pass phase 1; one at
    # HARQ_SNR_DB, where more blocks fail phase 2 than the compaction holds
    # (the full-batch branch: 5 iterations of the whole batch)
    branches = graph_path("5 DL", (("16 dB", dl(1)), ("16 dB again", dl(2)), ("clean", dl(3, None)),
                                   (f"{HARQ_SNR_DB} dB", dl(4, HARQ_SNR_DB))), smi)
    b_full = SISO_SHAPES["dl"][0]
    for draw, iters in (("clean", 1), (f"{HARQ_SNR_DB} dB", 5)):
        got = branches[draw]["phy.phch.pdsch.Pdsch.decode"]
        check(sum(n for k, n in got.items() if k[0] == "siso_windowed"
                  and k[1].startswith(f"B={b_full} ")) == 2 * iters,
              f"26 5 DL: the {draw} draw did not take the branch of {iters} full-batch "
              f"iterations: {dict(got)}")
    del chain, s

    for label, kw in (("13 SM 2x2 TM4", dict(ports=2, tm=4)), ("14 SM 4x4", dict(ports=4))):
        sm = SmChain(**kw)

        def sm_run(seed, sm=sm):
            def run():
                _, rx = sm.encode(seed)
                sm.receive(rx, SM_SNR_DB if sm.ports == 2 else SM4_SNR_DB, cuda_gen(seed))
            return run
        graph_path(label, (sm_run(SM_SEED), sm_run(SM_SEED + 1)), smi)
        del sm

    pm = Pmch(Cell(n_prb=100, id=1, cp=CP.EXT), area_id=1, sf_idx=3, mcs=20)
    o = pm.cell.ofdm
    ofdm = Ofdm(o, normalize=True)
    bits = torch.as_tensor(np.random.default_rng(SM_SEED + 4).integers(
        0, 2, (BATCH, pm.cfg.tbs), dtype=np.uint8), device="cuda")
    sig = ofdm.tx_sf(pm.encode(bits, torch.zeros((BATCH, o.nsymb_sf, o.nof_re),
                                                 dtype=torch.complex64, device="cuda")))
    pmch_draws = [lambda seed=seed: pm.decode(ofdm.rx_sf(UlChain.noisy(sig, 20.0, cuda_gen(seed))))
                  for seed in (1, 2)]
    graph_path("15 PMCH", pmch_draws, smi)
    (fn, args, kw), = first_calls(pmch_draws[1]).values()
    eviction_check("15 PMCH", fn, args, kw, smi)
    del bits, sig

    nr = NrChain("dl")

    def nr_run(seed):
        def run():
            _, tx = nr.encode(seed)
            gen = torch.Generator()
            gen.manual_seed(seed)
            rx = NrChain.noisy(tx, NR_SNR_DB["dl"], gen)
            nr.pdsch.demod_llr(rx)
            nr.pdsch.decode(rx)
        return run
    graph_path("20a NR DL", (nr_run(NR_SEED), nr_run(NR_SEED + 1)), smi)
    del nr

    if capture is None:
        capture = blind_capture(Cell(n_prb=BLIND_PRB, id=BLIND_CELL_ID, nof_ports=1))
    a = capture[0]
    fft = Cell(n_prb=BLIND_PRB).ofdm.symbol_sz
    graph_path("12 blind", (blind_draw(a, fft, BLIND_NOISE_SEED),
                                           blind_draw(a, fft, BLIND_NOISE_SEED + 1)), smi)

    x = 0
    for pci, gain in ((1, 1.0), (111, 10 ** (-10 / 20))):
        enb = EnbDl(Cell(n_prb=100, id=pci, nof_ports=1))
        x = x + gain * enb.gen_signal(enb.put_base(enb.empty_grids((10,), device="cuda"), 2))[:, 0]
    im = IntraMeasure(100, (1, 111, 300))
    graph_path("17 IntraMeasure", [
        (lambda seed=seed: im.measure(awgn(cuda_gen(seed), x, 10.0), 2)) for seed in (1, 2)], smi)

    sig = npdsch_enodeb.generate(NB_ID, NB_RNTI, NB_FRAMES, 5, 1, device="cuda")
    graph_path("22 NB-IoT", [
        (lambda seed=seed: npdsch_ue.receive(nb_impair(sig, *NB_IMPAIR[:3], seed), NB_RNTI,
                                             device="cuda"))
        for seed in (NB_IMPAIR[3], NB_IMPAIR[3] + 1)], smi)


# Phase 27: every branch of the DL-SCH cascade replayed from one graph.  The
# mixes of tests/test_torch_fec.py's CASCADE_CASES: 64 TBs of one K 512 code
# block each (TBS 488 over G 1056, QPSK: capacity 8, second capacity 2), drawn
# from a pool of 320 noisy TBs by the turbo iterations each needs before its
# CRC passes (99: never within 5), measured with the card's SISO kernel
CASCADE_CFG = dict(tbs=488, G=1056, Qm=2)
CASCADE_N = 64
CASCADE_MIXES = {
    "all_pass_after_early": {1: CASCADE_N},
    "all_pass_after_second": {1: CASCADE_N - 5, 2: 5},
    "compaction_then_clean": {1: CASCADE_N - 8, 2: 5, 3: 3},
    "second_compaction": {1: CASCADE_N - 8, 2: 3, 3: 3, 4: 1, 99: 1},
    "second_capacity_exceeded": {1: CASCADE_N - 8, 2: 2, 3: 2, 4: 2, 5: 1, 99: 1},
    "full_batch_fallback": {1: CASCADE_N - 14, 2: 3, 3: 5, 4: 3, 5: 2, 99: 1},
}


def cascade_pool(P=320):
    """tests/test_torch_fec.py's pool, built on the card: (bits, llr, need)
    as numpy, `need` measured one iteration at a time with the SISO kernel."""
    from srslte_tpu_torch.phy.fec import crc, tdec
    from srslte_tpu_torch.phy.phch import dlsch

    cfg = dlsch.DlschConfig(**CASCADE_CFG)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (P, cfg.tbs)).astype(np.uint8)
    coded = dlsch.dlsch_encode(bits, cfg, device="cuda").cpu().numpy().astype(np.float32)
    sigma = 10 ** (-np.linspace(-0.5, 5.0, P)[:, None] / 20)
    y = (1 - 2 * coded) + sigma * rng.standard_normal(coded.shape)
    llr = (-y * 2 / sigma**2).astype(np.float32)
    (K, _, w), = dlsch._derm_clusters(torch.as_tensor(llr, device="cuda"), cfg)
    st = tdec.turbo_start(w.reshape(P, -1), K)
    need = np.full(P, 99)
    for it in range(1, 6):
        st = tdec.turbo_step(st, K, 1, first=(it == 1))
        ok = crc.crc_ok_device(tdec.turbo_hard(st, K)[0], *crc.LTE_CRC24A).cpu().numpy()
        need[(need == 99) & ok] = it
    return bits, llr, need


def cascade_rows(name, need):
    """The pool rows of mix `name`, as tests/test_torch_fec.py draws them."""
    rng = np.random.default_rng(len(name))
    rows = np.concatenate([rng.choice(np.flatnonzero(need == n), c, replace=False)
                           for n, c in CASCADE_MIXES[name].items()])
    return rng.permutation(rows)


def counted_shapes(run):
    """(run()'s result, launches by (kernel, shape) as the counters read
    them after a fold), the card synchronised after run()."""
    by_shape = collections.Counter()
    with launch_shapes(by_shape):
        out = run()
        torch.cuda.synchronize()
    return out, by_shape


def phase_cascade(smi):
    """Phase 27: one graphed `dlsch_decode` key, captured on the mix whose
    blocks all pass phase 1, replayed on all six mixes; each replay equal to
    `__wrapped__` bit for bit, its launches (the conditional bodies it ran
    folded in) equal to the eager run's, by shape; the CRC flags what each
    TB's measured iteration count says, the bits the bits sent."""
    from srslte_tpu_torch.phy.phch import dlsch
    from srslte_tpu_torch.utils import jit

    toy = jit.stage(lambda x: jit.cond(
        x.sum() > 0, lambda: jit.cond(x.sum() > 10, lambda: x * 3, lambda: x * 2),
        lambda: (x - 1).abs() + torch.ones_like(x)))
    for v in (1.0, 5.0, -1.0, 5.0, 0.0):
        x = torch.full((4, 3), v, device="cuda")
        check(torch.equal(toy(x), toy.__wrapped__(x)), f"27: a nested cond on {v} differs")
    print(f"[27 cascade] nested conds replayed equal to eager on both sides of each predicate "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    bits, llr, need = cascade_pool()
    cfg = dlsch.DlschConfig(**CASCADE_CFG)
    print(f"[27 cascade] pool of {len(need)} TBs on the card in {time.perf_counter() - t0:.1f} s; "
          f"TBs by iterations needed {dict(sorted(collections.Counter(need.tolist()).items()))}",
          flush=True)
    rows = {name: cascade_rows(name, need) for name in CASCADE_MIXES}
    mixes = {name: torch.as_tensor(llr[r], device="cuda") for name, r in rows.items()}
    s0 = dict(jit.STATS)
    dlsch.dlsch_decode(mixes["all_pass_after_early"], cfg)
    torch.cuda.synchronize()
    s1 = dict(jit.STATS)
    check(s1["captures"] - s0["captures"] == 1, "27: the cascade captured more than one graph")
    key = jit.graph_key(dlsch.dlsch_decode, mixes["all_pass_after_early"], cfg)
    g = jit._GRAPHS[key]
    pool = tuple(jit._pool(torch.device("cuda", torch.cuda.current_device())))
    bodies = {s.cuda_stream for s in jit.BODY_STREAMS.values()}
    segs = [seg for seg in torch.cuda.memory_snapshot() if seg["stream"] in bodies]
    check(segs and all(tuple(seg["segment_pool_id"]) == pool for seg in segs),
          f"27: memory of the conditional bodies' streams outside the graphs' pool {pool}: "
          f"{[tuple(seg['segment_pool_id']) for seg in segs]}")
    print(f"[27 cascade] one graph captured in {s1['capture_ms'] - s0['capture_ms']:.1f} ms "
          f"with {s1['conds'] - s0['conds']} conds ({2 * (s1['conds'] - s0['conds'])} "
          f"conditional bodies on {len(bodies)} streams, {len(g.bodies)} of them launch a "
          f"counted kernel; every segment of those streams in the graphs' pool); the pool grew "
          f"{s1['pool_mb'] - s0['pool_mb']:.1f} MB", flush=True)
    for name, x in mixes.items():
        before = x.clone()
        r0 = jit.STATS["replays"]
        (gb, gok), g_shapes = counted_shapes(lambda: dlsch.dlsch_decode(x, cfg))
        replays = jit.STATS["replays"] - r0
        check(torch.equal(x, before), f"27 {name}: the graphed call changed its input")
        (eb, eok), e_shapes = counted_shapes(lambda: dlsch.dlsch_decode.__wrapped__(x, cfg))
        check(torch.equal(x, before), f"27 {name}: the eager call changed its input")
        check(replays == 1, f"27 {name}: {replays} replays")
        check(torch.equal(gb, eb) and torch.equal(gok, eok),
              f"27 {name}: the replay differs from __wrapped__")
        check(g_shapes == e_shapes, f"27 {name}: launches replayed {dict(g_shapes)}, "
                                    f"eager {dict(e_shapes)}")
        want = torch.as_tensor(need[rows[name]] <= 5, device="cuda")
        check(torch.equal(gok, want), f"27 {name}: CRC flags differ from the iterations needed")
        sent = torch.as_tensor(bits[rows[name]], device="cuda")
        check(torch.equal(gb[gok], sent[gok]), f"27 {name}: a TB that passed differs")
        ms_g, _ = median_ms(lambda: dlsch.dlsch_decode(x, cfg))
        ms_e, _ = median_ms(lambda: dlsch.dlsch_decode.__wrapped__(x, cfg))
        branch = ", ".join(f"{n} x {k[1].split(' L=')[0]}" for k, n in sorted(g_shapes.items()))
        print(f"[27 cascade] {name}: 1 replay equal to __wrapped__ bit for bit, TB ok "
              f"{int(gok.sum())}/{CASCADE_N}; SISO launches replayed = eager: {branch}; ms "
              f"graphed {ms_g:.3f}, eager {ms_e:.3f}; {smi}", flush=True)
    check(jit.STATS["captures"] == s1["captures"], "27: a mix captured a graph of its own")
    # the path of the `kernels` line: the six replays, counted
    torch.cuda.synchronize()
    reset_counts()
    for x in mixes.values():
        dlsch.dlsch_decode(x, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["siso_windowed"] > 0, "27: the cascade did not launch the SISO kernel")
    print(f"[27 cascade] the six replays' launches {counts}", flush=True)
    return counts


def stack_profile(prof, wall_ms, label="A bulk"):
    """The device's busy share and top kernels over a bulk window."""
    rows, busy_us = device_rows(prof)
    print(f"[profile full stack, {label}] {wall_ms:.1f} ms on the host clock (with the "
          f"profiler's overhead): {sum(r[1] for r in rows)} kernels and copies, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {100 - 100 * busy_us / (wall_ms * 1e3):.1f} %")
    for us, count, key in rows[:14]:
        print(f"[profile full stack, {label}]   {us / 1e3:8.3f} ms  {count:6d} x  {key[:90]}")
    sys.stdout.flush()


def device_rows(prof):
    """(rows (device us, count, name) by time, busy us) of a profile's
    kernel events: an operator's row repeats the time of its kernels."""
    from torch.autograd import DeviceType

    rows = sorted(((k.self_device_time_total, k.count, k.key) for k in prof.key_averages()
                   if k.device_type == DeviceType.CUDA and k.self_device_time_total > 0),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    check(busy_us > 0, "the profiler saw no device time")
    return rows, busy_us


def phase_profile(label, run, dispatch_ms):
    """One dispatch (`run()`) under torch.profiler: the device's kernel time
    by name, and its share of an unprofiled dispatch (`dispatch_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, busy_us = device_rows(prof)
    print(f"[profile {label}] one dispatch under the profiler ({wall_us / 1e3:.2f} ms on the host "
          f"clock with its overhead): {sum(r[1] for r in rows)} kernels and copies, device busy "
          f"{busy_us / 1e3:.2f} ms = {100 * busy_us / (dispatch_ms * 1e3):.1f} % of an unprofiled "
          f"dispatch ({dispatch_ms:.3f} ms), idle share {100 - 100 * busy_us / (dispatch_ms * 1e3):.1f} %")
    siso_us = sum(us for us, _, key in rows if "siso_kernel" in key)
    print(f"[profile {label}] SISO kernels {siso_us / 1e3:.3f} ms = {100 * siso_us / busy_us:.1f} % "
          f"of the busy time")
    vit = [(us, count) for us, count, key in rows if "viterbi_kernel" in key]
    print(f"[profile {label}] Viterbi kernel {sum(us for us, _ in vit) / 1e3:.4f} ms in "
          f"{sum(count for _, count in vit)} launches")
    for us, count, key in rows[:14]:
        print(f"[profile {label}]   {us / 1e3:8.3f} ms  {count:5d} x  {key[:90]}")
    sys.stdout.flush()


def main():
    from srslte_tpu_torch.utils import jit

    walls, captures = {}, {}
    t_all = time.perf_counter()

    def lap(name):
        """The wall time since the last lap, under `name`, and the CUDA
        graphs captured meanwhile (count, host ms)."""
        now = time.perf_counter()
        walls[name] = now - lap.t
        captures[name] = (jit.STATS["captures"] - lap.n, jit.STATS["capture_ms"] - lap.ms)
        lap.t, lap.n, lap.ms = now, jit.STATS["captures"], jit.STATS["capture_ms"]

    lap.t, lap.n, lap.ms = t_all, 0, 0.0
    smi = phase_device()
    phase_build()
    lap("1-2 device and build")
    kernels = phase_kernels()
    lap("3 kernels")
    chain = Chain()
    t0 = time.perf_counter()
    bits, s = chain.encode(seed=31)
    torch.cuda.synchronize()
    check(s.shape == (BATCH, 30720) and bool(torch.isfinite(torch.view_as_real(s)).all()),
          "stimulus shape or values")
    print(f"[4 main path] stimulus: {BATCH} subframes encoded on the card in "
          f"{time.perf_counter() - t0:.1f} s (tables built and uploaded on first use)", flush=True)
    phase_clean(chain, bits, s)
    counts_dl, counts_dl16, dispatch_ms = phase_noisy(chain, bits, s)

    ul = UlChain()
    t0 = time.perf_counter()
    ul_bits, ack, cqi, ul_s = ul.encode(seed=37)
    torch.cuda.synchronize()
    check(ul_s.shape == (BATCH, 30720) and bool(torch.isfinite(torch.view_as_real(ul_s)).all()),
          "UL stimulus shape or values")
    print(f"[6 UL path] stimulus: {BATCH} subframes encoded on the card by UeUl in "
          f"{time.perf_counter() - t0:.1f} s (tables built and uploaded on first use)", flush=True)
    lap("4-5 DL")
    counts_ul, ul_ms = phase_ul(ul, ul_bits, ack, cqi, ul_s)
    lap("6-7 UL")
    profile = "--profile" in sys.argv[1:]
    if profile:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(99)
        phase_profile("DL", lambda: chain.decode(s, SNR_DB, gen), dispatch_ms)
        phase_profile("UL", lambda: ul.decode(ul_s, UL_SNR_DB, gen), ul_ms)
    del s, ul_s
    lap("DL and UL profiles")
    phase_gold()
    phase_gates()
    lap("8-9 Gold sequence and BLER gates")
    counts_harq, _ = phase_harq(chain, np.random.default_rng(2025), profile)
    lap("10 DL HARQ")
    phase_ul_control(profile)
    lap("11 UL control")
    counts_blind, capture = phase_blind(profile)
    lap("12 blind receive")
    counts_sm2, _, sm = phase_sm2(profile)
    lap("13 SM 2x2")
    counts_sm4, _ = phase_sm4(profile)
    lap("14 SM 4x4")
    counts_rest = phase_dl_rest(sm)
    del sm
    lap("15 rest of the DL")
    counts_channel = phase_channel(profile)
    lap("16 channel")
    counts_rails = phase_rails(capture, profile)
    lap("17 rails")
    counts_stack = phase_stack(smi, profile)
    lap("18 full stack")
    counts_s1 = phase_s1(smi, profile)
    lap("19 S1 wire")
    phase_nr(smi, profile)
    lap("20 NR PHY")
    phase_nr_stack(smi)
    lap("21 NR stack")
    counts_nbiot = phase_nbiot(smi)
    lap("22 NB-IoT")
    counts_sl = phase_sidelink(smi)
    lap("23 sidelink")
    counts_scale = phase_scale_out(smi)
    lap("24 scale-out")
    phase_scripts(capture, smi)
    lap("25 entry points")
    phase_graphs(smi, capture)
    lap("26 one dispatch per call")
    counts_cascade = phase_cascade(smi)
    lap("27 cascade branches")
    counts = {"dl_f32": counts_dl, "dl_bf16": counts_dl16, **counts_ul, "dl_harq": counts_harq,
              "blind": counts_blind, **counts_sm2, **counts_sm4, **counts_rest, **counts_channel,
              "rails": counts_rails, "stack": counts_stack, "s1": counts_s1,
              "nbiot": counts_nbiot, "sidelink": counts_sl, **counts_scale,
              "cascade": counts_cascade}
    print(f"[graphs] CUDA graphs captured per phase (count, host ms of warm-up and capture): "
          f"{', '.join(f'{k} {n} {ms:.0f}' for k, (n, ms) in captures.items())}; in the cache "
          f"{jit.graphs()}", flush=True)
    print(f"[wall] seconds per phase: {', '.join(f'{k} {v:.1f}' for k, v in walls.items())}; "
          f"total {time.perf_counter() - t_all:.1f}", flush=True)
    line = []
    for name, k in kernels.items():
        # per path: the launches of its one counted noisy dispatch, and the
        # kernel's times and bound at the shape of that path's first launch;
        # the top-level numbers are those of MAIN_PATH
        times = k.pop("_times")
        key = 1 if name == "viterbi_decode" else 0
        by_path = {p: {"launches": counts[p][name], **times[PATHS[p][key]]}
                   for p in KERNEL_PATHS[name]}
        for p, v in by_path.items():
            check(v["launches"] > 0, f"{name} was not launched on the {p} path")
        line.append({"name": name, **k, "path": MAIN_PATH[name], **by_path[MAIN_PATH[name]],
                     "by_path": by_path})
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
