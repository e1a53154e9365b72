"""The readings the check's limits are set from (see PERF.md, "What decides
`correct`"), on a card, one cell per process:

    python3 benchmark/readings.py --workload <cell> --seeds <first> <count>
        [--variants program,ulp_input,eager,strided] [--controls <n>]
        [--sweep 15.0,15.2,...] [--sweep-seeds <n>] [--edge-snr <dB>]

Prints one JSON line per seed (each variant's compared numbers, and the TBs
the reference loses) and, with `--sweep`, one per SNR and seed.  The
controls (`prog_bf16`, `ref_bf16`) run on the first `--controls` seeds.
The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    from benchmark.harness import cells, imports, readings, runner

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, metavar=("FIRST", "COUNT"), required=True)
    ap.add_argument("--variants", default="program,ulp_input,eager")
    ap.add_argument("--controls", type=int, default=0)
    ap.add_argument("--sweep", default="")
    ap.add_argument("--sweep-seeds", type=int, default=1)
    ap.add_argument("--edge-snr", type=float)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = readings.Bench(cells.find(args.workload), args.device)
    first, count = args.seeds
    for s in range(first, first + args.sweep_seeds if args.sweep else first):
        snrs = [float(x) for x in args.sweep.split(",")]
        for row in bench.sweep(s, snrs):
            print(json.dumps({"workload": args.workload, "seed": s, "sweep": row}), flush=True)
    variants = [v for v in args.variants.split(",") if v]
    for n, s in enumerate(range(first, first + count)):
        t = time.perf_counter()
        vs = variants + (list(runner.CONTROLS) if n < args.controls else [])
        r = bench.read(s, vs, args.edge_snr)
        print(json.dumps({"workload": args.workload, "seed": s,
                          "edge_snr_db": args.edge_snr or bench.traffic["edge_snr_db"],
                          "seconds": time.perf_counter() - t, **r}), flush=True)
    bad = imports.forbidden_loaded()
    if bad:
        print(f"the process holds the modules {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
