"""The readings that the check's limits are set from, outside the window.

One process builds a cell's deployments once, then for each seed makes the
pool and the edge batches, runs the reference on the batches a run checks,
and compares with it each variant's outputs on the same batches, with the
check's own numbers (the path's `compare`):

- `program`: the timed path as a run drives it (graphed, float32);
- `ulp_input`: the same on the input moved by one ulp up or down at random,
  a stand-in for any sound change of float32 rounding;
- `eager`: the program's eager path (each entry point's `__wrapped__`: no
  graphs, the cascade's conds read on the host);
- `strided` (paths that take it): the reference with rx 0's noise handed to
  `decode2` as a strided view, so that its batch mean sums in another order;
- `prog_bf16`, `ref_bf16`: the controls of `runner.CONTROLS`.

`sweep` runs only the program, on edge batches at several SNRs, and reads
the TB error rate in float32 and with the 16-bit SISO, and the CRC flags
that the 16-bit SISO and the moved input change.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import deploy, runner
from benchmark.reference import stimulus


class Bench:
    """A cell's program and reference deployments on one device."""

    def __init__(self, cell, device: str = "cuda"):
        self.cell, self.path, self.traffic = cell, cell.path, cell.traffic
        self.dev = torch.device(device)
        if self.dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            from srslte_tpu_torch.ops import _build

            _build.build_all()
        self.prog = deploy.build(cell.config, deploy.PROGRAM, self.dev)
        self.ref = deploy.build(cell.config, deploy.REFERENCE, self.dev)

    def outputs(self, variant: str, rx, seed: int) -> dict:
        path, prog, ref = self.path, self.prog, self.ref
        if variant == "program":
            return path.receive(prog, rx)
        if variant == "prog_bf16":
            return path.receive(prog, rx, siso_dtype=torch.bfloat16)
        if variant == "ulp_input":
            return path.receive(prog, ulp_moved(rx, seed))
        if variant == "eager":
            from srslte_tpu_torch.utils import jit

            with jit._nested():  # every entry point runs as its `__wrapped__`
                return path.receive(prog, rx)
        if variant == "strided":
            return path.receive(ref, rx, contiguous_noise=False)
        if variant == "ref_bf16":
            return path.receive(ref, rx, lowp=True)
        raise ValueError(f"unknown variant {variant!r}")

    def batches(self, seed: int, edge_snr_db=None):
        """[(kind, source, index)] of the batches a run with `seed` checks."""
        pool = stimulus.make_pool(self.ref, self.traffic, seed, self.dev)
        edge = stimulus.make_edge(self.ref, self.traffic, seed, self.dev, edge_snr_db)
        rng = np.random.default_rng(seed)
        checked = sorted(rng.choice(pool.batches, size=min(self.traffic["check_batches"],
                                                              pool.batches),
                                    replace=False).tolist())
        return ([("pool", pool, p) for p in checked]
                + [("edge", edge, e) for e in range(edge.batches)])

    def read(self, seed: int, variants, edge_snr_db=None) -> dict:
        """{variant: the compared numbers} for `seed`, with `failed_ref`:
        the TBs whose CRC fails in the reference, on the pool batches and on
        the edge batches."""
        numbers = {v: {} for v in variants}
        failed = {"pool": 0, "edge": 0}
        for kind, src, i in self.batches(seed, edge_snr_db):
            rx = src.rx[i]
            want = self.path.receive(self.ref, rx)
            failed[kind] += sum(int((~want[k]).sum()) for k in want if k.startswith("tb_ok"))
            for v in variants:
                got = self.outputs(v, rx, seed)
                runner._aggregate(numbers[v], self.path.compare(got, want, src, i))
                del got
            del want
        return {"numbers": numbers, "failed_ref": failed}

    def sweep(self, seed: int, snrs) -> list:
        """Per SNR: the program's TB error rate in float32 and with the
        16-bit SISO, and the CRC flags that the 16-bit SISO and the moved
        input change, over the edge batches of `seed` at that SNR."""
        rows = []
        for snr in snrs:
            edge = stimulus.make_edge(self.ref, self.traffic, seed, self.dev, snr)
            tbs = fail32 = fail16 = flip16 = flip_ulp = 0
            for e in range(edge.batches):
                rx = edge.rx[e]
                a = self.outputs("program", rx, seed)
                b = self.outputs("prog_bf16", rx, seed)
                c = self.outputs("ulp_input", rx, seed)
                for k in (k for k in a if k.startswith("tb_ok")):
                    tbs += a[k].numel()
                    fail32 += int((~a[k]).sum())
                    fail16 += int((~b[k]).sum())
                    flip16 += int((a[k] != b[k]).sum())
                    flip_ulp += int((a[k] != c[k]).sum())
            rows.append({"snr_db": snr, "tbs": tbs, "bler_f32": fail32 / tbs,
                         "bler_bf16": fail16 / tbs, "flags_bf16": flip16,
                         "flags_ulp_input": flip_ulp})
        return rows


def ulp_moved(rx: torch.Tensor, seed: int) -> torch.Tensor:
    """rx with each real and imaginary part moved by one ulp, up or down at
    random (from the seed)."""
    r = torch.view_as_real(rx)
    g = stimulus.generator(seed, r.device, stream=2)
    up = torch.rand(r.shape, generator=g, device=r.device) < 0.5
    moved = torch.where(up, torch.nextafter(r, torch.full_like(r, float("inf"))),
                        torch.nextafter(r, torch.full_like(r, float("-inf"))))
    return torch.view_as_complex(moved.contiguous())
