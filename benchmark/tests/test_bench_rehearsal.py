"""Both paths end to end on the CPU at 6 PRB, with the plain kernels, from
test-only configurations that are not cells: the run, its result line, the
controls, and the faults the check must catch with the timed path broken
underneath.  One chip holds each cell, so no exchange between chips can be
left out."""

import json

import pytest
import torch

from benchmark.harness import deploy, runner
from benchmark.reference import stimulus
from benchmark.tests.helpers import rehearsal_cell

PATHS = ("dl_1port", "dl_sm")
SEED = 2**31 + 11  # more than 32 signed bits hold


@pytest.mark.parametrize("path_name", PATHS)
def test_a_run_is_correct_and_prints_the_contract(path_name):
    r = runner.run(rehearsal_cell(path_name), SEED, 0.3, device="cpu")
    assert r["correct"], runner.describe(r)
    assert r["attempted"] > 0 and 0 <= r["failed"] < r["attempted"]
    assert set(r["metrics"]) == {"tti_per_s", "dispatch_p95_ms", "peak_device_mb", "setup_s"}
    assert all(m["value"] >= 0 for m in r["metrics"].values())
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert set(r["check"]) == set(rehearsal_cell(path_name).path.LIMITS)
    json.dumps(r)


@pytest.mark.parametrize("path_name", PATHS)
def test_a_traced_run(path_name):
    cell = rehearsal_cell(path_name)
    r = runner.run(cell, SEED + 1, 0.3, trace=True, device="cpu")
    assert r["correct"], runner.describe(r)
    assert r["attempted"] == cell.traffic["trace_dispatches"] * cell.path.transport_blocks(
        None, cell.traffic["batch"])
    # the host's reader finds its clock; the device's find no card here
    assert set(r["metrics"]) == {"host_issue_ms"}
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "check"


def test_the_pool_is_a_function_of_the_seed():
    cell = rehearsal_cell("dl_sm")
    dep = deploy.build(cell.config, deploy.REFERENCE, "cpu")
    a, b = (stimulus.make_pool(dep, cell.traffic, SEED, "cpu") for _ in range(2))
    c = stimulus.make_pool(dep, cell.traffic, SEED + 1, "cpu")
    assert torch.equal(a.rx, b.rx) and torch.equal(a.bits, b.bits) and torch.equal(a.ack, b.ack)
    assert not torch.equal(a.bits, c.bits)
    assert a.rx.shape[:2] == (cell.traffic["pool_batches"], cell.traffic["batch"])
    assert not torch.equal(a.rx[0], a.rx[1])  # distinct batches


# the program's own 16-bit SISO moves only CRC flags at the turbo decoder's
# threshold, too few in a rehearsal's few TBs to pass the flags' limit:
# `test_bench_chip.py` holds that control at each cell's own size
@pytest.mark.parametrize("path_name, control, number", [
    ("dl_1port", "ref_bf16", "front_end_err"), ("dl_sm", "ref_bf16", "front_end_err")])
def test_the_controls_fail_the_check(path_name, control, number):
    r = runner.run(rehearsal_cell(path_name), SEED, 0.2, device="cpu", control=control)
    assert not r["correct"]
    assert r["check"][number]["value"] > r["check"][number]["limit"], runner.describe(r)


def _state_unchanged(monkeypatch, path_name):
    """The turbo decoder's iterations return their state unchanged."""
    from srslte_tpu_torch.phy.fec import tdec

    monkeypatch.setattr(tdec, "turbo_step", lambda st, K, n, first=False: st)


def _half_batch(monkeypatch, path_name):
    """The front end estimates the first half of the batch only and hands
    its results to the second half as well."""
    from srslte_tpu_torch.phy.ue.ue_dl import UeDl

    orig = UeDl.fft_estimate

    def half(self, samples, sf_idx, device=None):
        n = samples.shape[0] // 2
        grid, ce, info = orig(self, samples[:n], sf_idx, device)
        twice = (lambda t: torch.cat([t, t])[: samples.shape[0]])
        return twice(grid), twice(ce), {k: twice(v) for k, v in info.items()}

    monkeypatch.setattr(UeDl, "fft_estimate", half)


def _answer_altered(monkeypatch, path_name):
    """One bit of one TB flipped where the PDSCH decoder produces it."""
    from srslte_tpu_torch.phy.phch import pdsch

    cls, name = (pdsch.Pdsch, "decode") if path_name == "dl_1port" else (pdsch.PdschSm,
                                                                           "decode2")
    orig = getattr(cls, name)

    def flip(bits_ok):
        bits, ok = bits_ok
        bits = bits.clone()
        bits[0, 0] ^= 1
        return bits, ok

    def altered(self, *args, **kw):
        out = orig(self, *args, **kw)
        return flip(out) if path_name == "dl_1port" else (flip(out[0]), out[1])

    monkeypatch.setattr(cls, name, altered)


def _cfi_altered(monkeypatch, path_name):
    """Subframe 0's CFI altered where the PCFICH decoder produces it."""
    from srslte_tpu_torch.phy.phch.pcfich import Pcfich

    orig = Pcfich.decode

    def altered(self, *args, **kw):
        cfi, conf = orig(self, *args, **kw)
        cfi = cfi.clone()
        cfi[0] = cfi[0] % 3 + 1
        return cfi, conf

    monkeypatch.setattr(Pcfich, "decode", altered)


FAULTS = {"state_unchanged": (_state_unchanged, "tb_flag_diff"),
          "half_batch": (_half_batch, "front_end_err"),
          "answer_altered": (_answer_altered, "tb_bits_diff"),
          "cfi_altered": (_cfi_altered, "cfi_diff")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("path_name", PATHS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, path_name, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch, path_name)
    r = runner.run(rehearsal_cell(path_name), SEED + 2, 0.2, device="cpu")
    assert not r["correct"]
    assert r["check"][number]["value"] > r["check"][number]["limit"], runner.describe(r)


def test_the_readings_of_the_sound_variants():
    """The program and its eager path equal the reference; the input moved
    by one ulp moves the front end by rounding only."""
    from benchmark.harness import readings

    bench = readings.Bench(rehearsal_cell("dl_1port"), "cpu")
    rx = bench.batches(SEED)[0][1].rx[0]
    r, m = torch.view_as_real(rx), torch.view_as_real(readings.ulp_moved(rx, SEED))
    up = torch.nextafter(r, torch.tensor(float("inf")))
    down = torch.nextafter(r, torch.tensor(float("-inf")))
    assert torch.all((m == up) | (m == down)) and torch.any(m == up) and torch.any(m == down)
    numbers = bench.read(SEED, ["program", "eager", "ulp_input"])["numbers"]
    assert all(v == 0 for v in numbers["program"].values()), numbers
    assert all(v == 0 for v in numbers["eager"].values()), numbers
    assert 0 < numbers["ulp_input"]["front_end_err"] < 1e-5, numbers
