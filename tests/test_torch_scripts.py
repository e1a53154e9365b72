"""The JAX package's remaining entry-point scripts, ported under
`srslte_tpu_torch/examples/`, against the reference scripts on the CPU.

`cell_search.scan` against the root `examples/cell_search.py` on a 6 PRB
capture (delay, CFO, noise): the cell, the votes, the MIB and its port count
equal, the CFO within 1e-4 subcarrier.  `zmq_remote_rx.capture` against a
`ZmqTxServer`, every sample equal (needs pyzmq).  `run_epc` comes up as its
own process and writes its S1 port; `run_enb` and `run_ue` mean the card
unless `--device cpu` is given, and with it the three processes attach and
carry the SGi echo, as tests/test_three_process.py runs the JAX ones.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import examples.cell_search as j_cs  # noqa: E402
import srslte_tpu_torch.examples.cell_search as t_cs  # noqa: E402
import srslte_tpu_torch.examples.pdsch_enodeb as t_enodeb  # noqa: E402
import srslte_tpu_torch.examples.run_enb as t_run_enb  # noqa: E402
import srslte_tpu_torch.examples.run_ue as t_run_ue  # noqa: E402
import srslte_tpu_torch.phy.common.params as t_params  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# away from the reference tests' ports and from tests/test_torch_radio.py's
BASE = 43100 + 20 * int(os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:] or 0)
torch.set_num_threads(1)  # several test workers share the machine's cores


def capture_6prb(cell_id=123, delay=777, cfo=0.12, snr_db=20.0, seed=0):
    """Three frames of the port's example eNB at 6 PRB, delayed, with a CFO
    (in subcarriers) and AWGN."""
    cell = t_params.Cell(n_prb=6, id=cell_id, nof_ports=1)
    x = torch.cat([t_enodeb.make_frame(cell, 0x1234, 5, sfn, seed=7, device=CPU)[0].reshape(-1)
                   for sfn in range(3)]).numpy()
    x = np.concatenate([np.zeros(delay, np.complex64), x])
    x = x * np.exp(2j * np.pi * cfo * np.arange(len(x)) / cell.ofdm.symbol_sz)
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.mean(np.abs(x) ** 2) / 10 ** (snr_db / 10) / 2)
    return (x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def test_scan_matches_reference():
    x = capture_6prb()
    got, want = t_cs.scan(x, 6, device=CPU), j_cs.scan(x, 6)
    assert (got["cell_id"], got["votes"], got["nof_ports"]) == (
        want["cell_id"], want["votes"], want["nof_ports"]) == (123, want["votes"], 1)
    assert dataclasses.asdict(got["mib"]) == dataclasses.asdict(want["mib"])
    assert got["cfo_sc"] == pytest.approx(want["cfo_sc"], abs=1e-4)
    assert got["cfo_sc"] == pytest.approx(0.12, abs=0.01)
    # noise alone: no cell in either
    noise = capture_6prb(snr_db=-60.0)
    assert t_cs.scan(noise * 0, 6, device=CPU) is None and j_cs.scan(noise * 0, 6) is None


def test_scan_main_prints_the_cell(tmp_path, capsys):
    path = tmp_path / "c.bin"
    capture_6prb(cell_id=301).tofile(path)
    with pytest.raises(SystemExit) as done:
        t_cs.main([str(path), "--prb", "6", "--device", CPU])
    assert done.value.code == 0
    assert "found cell: PCI 301" in capsys.readouterr().out


def test_zmq_capture_from_a_tx_server(tmp_path):
    pytest.importorskip("zmq")
    from srslte_tpu_torch.examples import zmq_remote_rx
    from srslte_tpu_torch.net.zmq_rf import ZmqTxServer

    addr = f"tcp://127.0.0.1:{BASE}"
    bursts = [np.random.default_rng(i).standard_normal(2 * 1920).astype(np.float32)
              .view(np.complex64) for i in range(3)]
    srv = ZmqTxServer(bind=addr)
    th = threading.Thread(target=lambda: [srv.serve_once(b) for b in bursts])
    th.start()
    try:
        got = zmq_remote_rx.capture(addr, 2 * 1920 + 100)
    finally:
        th.join(10)
        srv.close()
    np.testing.assert_array_equal(got, np.concatenate(bursts)[: 2 * 1920 + 100])
    # a server that never answers: what arrived before the timeout
    got = zmq_remote_rx.capture(f"tcp://127.0.0.1:{BASE + 1}", 100, timeout_ms=200)
    assert got.shape == (0,) and got.dtype == np.complex64


@pytest.mark.parametrize("main,argv", [(t_run_enb.main, ["36412"]), (t_run_ue.main, [])],
                         ids=["run_enb", "run_ue"])
def test_apps_mean_the_card_by_default(main, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


def spawn(module, *args):
    return subprocess.Popen([sys.executable, "-u", "-m", f"srslte_tpu_torch.examples.{module}",
                             *map(str, args)], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_three_processes_attach_and_echo_on_the_host(tmp_path):
    """run_epc writes its S1 port; run_enb and run_ue with --device cpu
    attach over the UDP sample pipe and carry the SGi echo."""
    port_file = tmp_path / "s1_port"
    procs = [spawn("run_epc", port_file)]
    try:
        deadline = time.time() + 60
        while not port_file.exists() or not port_file.read_text():
            assert time.time() < deadline, "EPC never came up"
            assert procs[0].poll() is None, procs[0].stdout.read()
            time.sleep(0.1)
        s1_port = int(port_file.read_text())
        assert 0 < s1_port < 65536
        dl, ul = BASE + 2, BASE + 3
        procs.append(spawn("run_enb", s1_port, dl, ul, "--device", CPU))
        assert procs[1].stdout.readline().startswith("ENB ready")
        procs.append(spawn("run_ue", dl, ul, "--device", CPU))
        lines = []
        deadline = time.time() + 240
        while time.time() < deadline:
            line = procs[2].stdout.readline()
            if not line:
                break
            lines.append(line.strip())
            if line.startswith("DL_DATA"):
                break
        assert lines[0] == "UE ready", lines
        assert any(s.startswith("ATTACHED tti=") for s in lines), lines
        assert lines[-1] == "DL_DATA echo:ping-3proc", lines
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=10)
