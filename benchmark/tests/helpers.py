"""Helpers of the benchmark's tests."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
# the CPU rehearsal's cells: a test-only configuration (not a cell of
# BENCHMARK.json) under a traffic mix whose SNR leaves some TBs to the
# turbo decoder's later iterations
TEST_CELLS = {"dl_1port": ("test6_dl_1x1", "test_batch4_snr11"),
              "dl_sm": ("test6_dl_tm4_2x2", "test_batch4_snr15")}


def rehearsal_cell(path_name: str):
    """The rehearsal cell of a path, with BENCHMARK.json's metrics."""
    import torch

    from benchmark.harness import cells

    torch.set_num_threads(2)
    conf, mix = TEST_CELLS[path_name]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((DATA / f"{conf}.json").read_text())
    traffic = json.loads((DATA / f"{mix}.json").read_text())
    return cells.Cell(f"test.{path_name}", 1, config, traffic, cells.path(config["path"]),
                      bench["end_to_end"], bench["per_layer"])
