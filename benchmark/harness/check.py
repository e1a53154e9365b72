"""The numbers that decide `correct`: the program's outputs against the
reference's, on the same batch.

Each number has a limit (the path module's `LIMITS`); a run is correct when
every number is at or under its limit.  PERF.md gives the readings each
limit was set from: the program's sound runs and float32 reorders of the
reference below it, the lower-precision controls above it.  Decisions that
sit far from a threshold (CFI, DCI, HI, the bits of a transport block that
passes its CRC on both sides) compare exactly.  A transport block's CRC
flag can change under any change of float32 rounding when the block sits at
the turbo decoder's threshold, so the flags compare as a count with room.
"""

from __future__ import annotations

import torch


def bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 and back (complex: each part): what a stage
    computed in bfloat16 hands to the next."""
    if t.is_complex():
        return torch.view_as_complex(torch.view_as_real(t).to(torch.bfloat16).float()
                                     .contiguous())
    return t.to(torch.bfloat16).to(t.dtype)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over the largest |b|."""
    scale = torch.abs(b).max()
    return float(torch.abs(a - b).max() / torch.clamp(scale, min=1e-30))


def front_end_err(out: dict, ref: dict) -> float:
    """The worst relative error of the grid, the channel estimate and the
    noise estimate."""
    return max(rel_err(out[k], ref[k]) for k in ("grid", "ce", "noise"))


def dci_diff(out: dict, ref: dict) -> int:
    """Candidates whose CRC flag differs from the reference's, or whose
    payload differs where the reference's CRC passes."""
    return int(((out["ok"] != ref["ok"])
                | (ref["ok"] & torch.any(out["cand"] != ref["cand"], dim=-1))).sum())


def tb_flag_diff(ok, ref_ok) -> int:
    """Transport blocks whose CRC flag differs from the reference's."""
    return int((ok != ref_ok).sum())


def tb_bits_diff(bits, ok, ref_bits, ref_ok) -> int:
    """Transport blocks that pass their CRC on both sides with bits that
    differ (the bits of a block that fails are the decoder's noise)."""
    return int((ok & ref_ok & torch.any(bits != ref_bits, dim=-1)).sum())


def dci_found(out: dict, sent: torch.Tensor) -> torch.Tensor:
    """[B] bool: a candidate passed its CRC with the payload sent."""
    return torch.any(out["ok"] & torch.all(out["cand"] == sent, dim=-1), dim=-1)


def outputs_differ(out: dict, kept: dict, keys) -> torch.Tensor:
    """0-d int64 on the device: 1 if any of `keys` differs between two
    dispatches of the same pool batch."""
    d = torch.zeros((), dtype=torch.bool, device=out[keys[0]].device)
    for k in keys:
        d = d | torch.any(out[k] != kept[k])
    return d.to(torch.int64)
