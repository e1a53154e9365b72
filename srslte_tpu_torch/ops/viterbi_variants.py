"""Source variants of the Viterbi kernel timed against the committed one, on
one NVIDIA GPU: ``python3 -m srslte_tpu_torch.ops.viterbi_variants`` from
the repository root (it takes its timer from ``chip_smoke.py``).

A variant is ``csrc/viterbi.cu`` with a few exact text replacements (built
as ``siso_variants`` builds its variants) and its candidates per block.  At
each path's shape (``chip_smoke.VIT_SHAPES``) and for one candidate alone,
every variant is first held to the plain version bit for bit (noisy and
erased-tail inputs, tail-biting, and without tail-biting at the DL's shape),
then timed in `ROUNDS` rounds of `LAUNCHES` launches each, by CUDA events,
the order of the variants reversed every other round.  Printed per variant
and shape: the median over the rounds, their range, the ratio to the
committed kernel, the resident candidates per SM and the registers.  The
last line is one JSON object of them.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from . import viterbi_cuda
from .siso_variants import build_variants

ROUNDS = 8
LAUNCHES = 20

# Two warps, two candidates, per block: the blocks spread over the SMs in
# pairs.
TWO_PER_BLOCK = [
    ("constexpr int CANDIDATES = 1;", "constexpr int CANDIDATES = 2;"),
]

# Each step's decision words stored by lane 0 in the step that takes them,
# so that the in-order issue holds the next step behind the vote.
STORE_IN_STEP = [
    ("""            if (first) *pending = make_uint2((bp & even) | (bq & ~even), (bq & even) | (bp & ~even));
            bp = __ballot_sync(FULL, P != (upper ? yp : xp));
            bq = __ballot_sync(FULL, Q != (upper ? yq : xq));
            pending = d;""",
     """            bp = __ballot_sync(FULL, P != (upper ? yp : xp));
            bq = __ballot_sync(FULL, Q != (upper ? yq : xq));
            if (first) *d = make_uint2((bp & even) | (bq & ~even), (bq & even) | (bp & ~even));"""),
    ("""    if (first) *pending = make_uint2((bp & even) | (bq & ~even), (bq & even) | (bp & ~even));

    // The end state""", """    // The end state"""),
]

# name -> (replacements, candidates per block)
VARIANTS = {
    "committed": ([], viterbi_cuda.CANDIDATES_PER_BLOCK),
    "two_per_block": (TWO_PER_BLOCK, 2),
    "store_in_step": (STORE_IN_STEP, viterbi_cuda.CANDIDATES_PER_BLOCK),
}


def plan_for(B: int, length: int, tail_biting: bool, per_block: int) -> viterbi_cuda.ViterbiPlan:
    return viterbi_cuda.ViterbiPlan(
        per_block, -(-B // per_block), 32 * per_block,
        per_block * viterbi_cuda.smem_per_candidate(length, tail_biting))


def inputs(rng, B: int, length: int, erased: bool):
    """Tail-biting code words at BPSK with noise (sigma 0.8) on the card;
    with `erased`, clean with the last 8 steps at LLR 0."""
    from srslte_tpu_torch.phy.fec import convolutional

    bits = rng.integers(0, 2, (B, length)).astype(np.uint8)
    coded = torch.as_tensor(convolutional.conv_encode_np(bits), dtype=torch.float32, device="cuda")
    noise = torch.as_tensor(rng.standard_normal(coded.shape, dtype=np.float32), device="cuda")
    llr = -(1 - 2 * coded) + (0.0 if erased else 0.8) * noise
    if erased:
        llr[:, -24:] = 0.0
    return llr.contiguous()


def main():
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("viterbi_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(VARIANTS, "viterbi")
    fns = {name: viterbi_cuda._entry(lib) for name, (lib, _) in libs.items()}
    rng = np.random.default_rng(11)
    shapes = {**cs.VIT_SHAPES, "one": (1, cs.VIT_SHAPES["dl"][1])}
    result = []
    for key, (B, length) in shapes.items():
        for erased in (False, True):
            llr = inputs(rng, B, length, erased)
            for tb in (True, False) if key == "dl" else (True,):
                ref = viterbi_cuda.viterbi_decode_plain(llr, length, tb)
                for name, fn in fns.items():
                    got = viterbi_cuda._launch(fn, llr, length, tb,
                                               plan_for(B, length, tb, VARIANTS[name][1]))
                    nbad = int((got != ref).sum())
                    if nbad:
                        raise RuntimeError(f"{name} B={B} len={length} tail_biting={tb} "
                                           f"erased={erased}: {nbad} bits differ")
        llr = inputs(rng, B, length, False)
        runs = {name: (lambda fn=fn, p=plan_for(B, length, True, VARIANTS[name][1]):
                       viterbi_cuda._launch(fn, llr, length, True, p))
                for name, fn in fns.items()}
        times = {name: [] for name in runs}
        for r in range(ROUNDS):
            for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[name].append(cs.event_ms(runs[name], LAUNCHES))
        base = float(np.median(times["committed"]))
        for name, ts in times.items():
            plan = plan_for(B, length, True, VARIANTS[name][1])
            row = {"variant": name, "path": key, "shape": f"B={B} len={length} tail-biting",
                   "ms": float(np.median(ts)), "ms_min": min(ts), "ms_max": max(ts),
                   "candidates_per_sm": viterbi_cuda.blocks_per_sm(plan, libs[name][0])
                   * plan.candidates_per_block,
                   "registers": libs[name][1]}
            row["x_committed"] = row["ms"] / base
            result.append(row)
            print(f"{key} {name:14s} {row['ms']:.5f} ms [{row['ms_min']:.5f}, {row['ms_max']:.5f}] "
                  f"({row['x_committed']:.3f} x committed); {row['candidates_per_sm']} candidates "
                  f"per SM resident, registers {row['registers']}", flush=True)
    print(smi)
    print(json.dumps({"viterbi_variants": result}))


if __name__ == "__main__":
    sys.exit(main())
