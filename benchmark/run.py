"""The benchmark of srslte_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It loads, warms up, measures for `--seconds` (with `--trace 1`: profiles
the traffic mix's fixed stretch of dispatches instead), checks the outputs
against the reference, prints each compared number beside its limit as the
last lines on standard error, and prints the result as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` `breakdown`, and `check` (the compared numbers).  Without
enough CUDA devices, or with JAX or the JAX package loaded, it exits with
a code other than 0 and prints no result.

`--control prog_bf16` runs the program with its 16-bit SISO, `--control
ref_bf16` compares the reference computed in bfloat16 in the program's
place: the controls that the check must fail.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)  # import the benchmark and the port from the checkout's root
else:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    from benchmark.harness import cells, runner

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=runner.CONTROLS)
    args = ap.parse_args(argv)

    cell = cells.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    try:
        result = runner.run(cell, args.seed, args.seconds, trace=bool(args.trace),
                            device="cuda", control=args.control, t0=T0)
    except runner.ForbiddenModules as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(runner.describe(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
