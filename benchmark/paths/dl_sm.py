"""Path `dl_sm`: a UE's 2x2 spatial-multiplexing downlink subframe (TM4, DCI
format 2, two codewords), srsUE's `cc_worker` scope with PHICH, batched over
the subframes of a dispatch.

`UeDl.fft_estimate` on every rx antenna -> `Pcfich.decode`, the PDCCH blind
search and `Phich.decode` on rx 0 (the control channels read one antenna)
-> the candidates read back to the host, the DCI that most of them carry
unpacked and the `PdschSm` it schedules looked up (built on a new DCI) ->
`PdschSm.decode2` on every rx antenna with rx 0's noise.  The same sequence
runs the program's deployment (timed) and the reference's (after the
window, eagerly, with the plain kernels).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.harness import check

OUTPUTS = ("bits0", "tb_ok0", "bits1", "tb_ok1", "cfi", "ok", "cand", "hi")

LIMITS = {"front_end_err": 1e-4, "cfi_diff": 0, "dci_diff": 0, "hi_diff": 0,
          "tb_flag_diff": 15, "tb_bits_diff": 0, "replay_diff": 0}


def _none(name):
    return contextlib.nullcontext()


def _scheduled(dep, ok, cand):
    """The PDSCH processor of the DCI that most passing candidates carry
    (None when no candidate of the batch passed its CRC)."""
    both = torch.cat([ok[..., None].to(torch.uint8), cand], dim=-1).cpu().numpy()
    hits = both[..., 1:][both[..., 0] == 1]
    if not len(hits):
        return None
    payloads, n = np.unique(hits, axis=0, return_counts=True)
    dci = dep.unpack(payloads[np.argmax(n)], dep.cell.n_prb)
    cache = dep.__dict__.setdefault("scheduled", {})
    if dci not in cache:
        cache[dci] = dep.pdsch_for(dci)
    return cache[dci]


def receive(dep, rx, span=_none, siso_dtype=torch.float32, lowp=False,
            contiguous_noise=True) -> dict:
    """One dispatch: rx [B, nrx, sf_len] -> the outputs on the device.
    `lowp` computes in bfloat16 (the control): each stage's output rounded
    to it, and the SISO in it.  `contiguous_noise=False` hands `decode2`
    rx 0's noise as a strided view (a float32 reorder of the batch mean,
    for the check's readings)."""
    if lowp:
        rx, siso_dtype = check.bf16(rx), torch.bfloat16
    with span("front_end"):
        grid, ce, info = dep.ue.fft_estimate(rx, dep.sf_idx)  # [B, nrx, ...]
        if lowp:
            grid, ce = check.bf16(grid), check.bf16(ce)
    g0, c0 = grid[:, 0], ce[:, 0]
    with span("control"):
        cfi, _ = dep.pcfich.decode(g0, c0)
        ok, cand = dep.pd._decode_mixed_traced(g0, c0, dep.groups, dep.dci_len, dep.mask)
        pdsch = _scheduled(dep, ok, cand)
        hi, _ = dep.phich.decode(g0, c0)
    with span("data"):
        if pdsch is None:  # nothing to decode: every TB of the batch fails
            batch, tbs = grid.shape[0], dep.pdsch.cfg.tbs
            zero = torch.zeros((batch, tbs), dtype=torch.uint8, device=grid.device)
            no = torch.zeros((batch,), dtype=torch.bool, device=grid.device)
            (b0, ok0), (b1, ok1) = (zero, no), (zero, no)
        else:
            # rx 0's noise as a contiguous tensor: a graphed call copies its
            # inputs into contiguous buffers, and the batch mean the MMSE
            # regularises with sums in another order over a strided view
            noise = info["noise"][:, 0]
            (b0, ok0), (b1, ok1) = pdsch.decode2(
                grid, ce, noise.contiguous() if contiguous_noise else noise,
                siso_dtype=siso_dtype)
    return {"grid": grid, "ce": ce, "noise": info["noise"], "cfi": cfi, "ok": ok,
            "cand": cand, "hi": hi, "bits0": b0, "tb_ok0": ok0, "bits1": b1, "tb_ok1": ok1}


def transport_blocks(dep, batch: int) -> int:
    return 2 * batch


def failed(dep, out: dict, pool, p: int) -> torch.Tensor:
    """0-d int64 on the device: TBs (of both codewords) whose CRC failed,
    whose bits differ from those sent, or whose subframe's CFI or DCI was
    not decoded."""
    sf_ok = (out["cfi"] == dep.cfi) & check.dci_found(out, dep.dci_sent)
    n = torch.zeros((), dtype=torch.int64, device=sf_ok.device)
    for q in range(2):
        good = out[f"tb_ok{q}"] & torch.all(out[f"bits{q}"] == pool.bits[p, q], dim=-1) & sf_ok
        n = n + (~good).sum()
    return n


def compare(out: dict, ref: dict, pool, p: int) -> dict:
    """The compared numbers of one batch; HIs only where a HI was sent (an
    unsent sequence decodes as noise)."""
    sent = pool.ack[p] >= 0
    return {"front_end_err": check.front_end_err(out, ref),
            "cfi_diff": int((out["cfi"] != ref["cfi"]).sum()),
            "dci_diff": check.dci_diff(out, ref),
            "hi_diff": int(((out["hi"] != ref["hi"]) & sent).sum()),
            "tb_flag_diff": sum(check.tb_flag_diff(out[f"tb_ok{q}"], ref[f"tb_ok{q}"])
                                for q in range(2)),
            "tb_bits_diff": sum(check.tb_bits_diff(out[f"bits{q}"], out[f"tb_ok{q}"],
                                                   ref[f"bits{q}"], ref[f"tb_ok{q}"])
                                for q in range(2))}
