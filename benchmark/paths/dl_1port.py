"""Path `dl_1port`: a UE's 1-port downlink subframe, srsUE's
`cc_worker::work_dl_regular` scope, batched over the subframes of a
dispatch.

`UeDl.fft_estimate` -> `Pcfich.decode` -> the PDCCH blind search over every
candidate of the configuration's search (`Pdcch._decode_mixed_traced`, one
Viterbi batch) -> `Pdsch.decode` of the configured grant.  The same
sequence runs the program's deployment (timed, its entry points replaying
CUDA graphs on the card) and the reference's (after the window, eagerly,
with the plain kernels).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.harness import check

# what the MAC above needs from a subframe, copied to the host per dispatch
OUTPUTS = ("bits", "tb_ok", "cfi", "ok", "cand")

# limit of each compared number (PERF.md gives the readings they were set from)
LIMITS = {"front_end_err": 1e-4, "cfi_diff": 0, "dci_diff": 0, "tb_flag_diff": 10,
          "tb_bits_diff": 0, "replay_diff": 0}


def _none(name):
    return contextlib.nullcontext()


def receive(dep, rx, span=_none, siso_dtype=torch.float32, lowp=False) -> dict:
    """One dispatch: rx [B, sf_len] -> the outputs on the device.  `lowp`
    computes in bfloat16 (the control): each stage's output rounded to it,
    and the SISO in it."""
    if lowp:
        rx, siso_dtype = check.bf16(rx), torch.bfloat16
    with span("front_end"):
        grid, ce, info = dep.ue.fft_estimate(rx, dep.sf_idx)
        if lowp:
            grid, ce = check.bf16(grid), check.bf16(ce)
    with span("control"):
        cfi, _ = dep.pcfich.decode(grid, ce)
        ok, cand = dep.pd._decode_mixed_traced(grid, ce, dep.groups, dep.dci_len, dep.mask)
    with span("data"):
        bits, tb_ok = dep.pdsch.decode(grid, ce, info["noise"], siso_dtype=siso_dtype)
    return {"grid": grid, "ce": ce, "noise": info["noise"], "cfi": cfi, "ok": ok,
            "cand": cand, "bits": bits, "tb_ok": tb_ok}


def transport_blocks(dep, batch: int) -> int:
    return batch


def failed(dep, out: dict, pool, p: int) -> torch.Tensor:
    """0-d int64 on the device: TBs whose CRC failed, whose bits differ from
    those sent, or whose subframe's CFI or DCI was not decoded."""
    good = (out["tb_ok"] & torch.all(out["bits"] == pool.bits[p, 0], dim=-1)
            & (out["cfi"] == dep.cfi) & check.dci_found(out, dep.dci_sent))
    return (~good).sum()


def compare(out: dict, ref: dict, pool, p: int) -> dict:
    """The compared numbers of one batch (the counts add over batches, the
    error takes the largest)."""
    return {"front_end_err": check.front_end_err(out, ref),
            "cfi_diff": int((out["cfi"] != ref["cfi"]).sum()),
            "dci_diff": check.dci_diff(out, ref),
            "tb_flag_diff": check.tb_flag_diff(out["tb_ok"], ref["tb_ok"]),
            "tb_bits_diff": check.tb_bits_diff(out["bits"], out["tb_ok"], ref["bits"],
                                               ref["tb_ok"])}
