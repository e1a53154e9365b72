"""The port's radio rails against the JAX package: the g++-built native
runtime (ring buffer, UDP sample pipe, TTI clock), the UDP net source and
sink, the file and pipe radios, and the ZMQ RF transport.

Analogs of tests/test_native.py, tests/test_measure_radio.py's radio cases
and tests/test_aux_subsystems.py::test_zmq_rf_wire_protocol, and the wire
between the packages: the JAX package's sender to the port's receiver, bit
for bit.  Samples that cross a transport are compared exactly (the float32
values travel unchanged), the pipe radio's resampling to atol 2e-3 as in
the reference's test.

Every UDP and TCP port comes from a range of this file's own, spread per
xdist worker, away from the reference tests' ports (23452, 23979, 45678,
47001 and up).
"""

import os

import numpy as np
import pytest
import torch

import srslte_tpu.runtime as j_rt
import srslte_tpu_torch.runtime as t_rt
from srslte_tpu_torch.runtime import native

torch.set_num_threads(1)  # several test workers share the machine's cores

BASE = 42000 + 40 * int(os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:] or 0)


def cnoise(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


# ---------------------------------------------------------- native runtime
def test_native_library_is_the_ports_own():
    """Built by g++ into srslte_tpu_torch/_build under a hash of the port's
    own source: never the JAX package's native/libsrslte_tpu_native.so."""
    path = native.build()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "srslte_tpu_torch"
    assert path == native.lib_path() and native.SRC.parent == path.parent.parent / "runtime"


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_ring_buffer_roundtrip():
    rb = t_rt.NativeRingBuffer(1024)
    x = cnoise(0, 300)
    assert rb.write(x) == 300
    assert rb.size == 300
    np.testing.assert_array_equal(rb.read(300), x)
    assert rb.size == 0
    for _ in range(5):  # wrap-around across the capacity boundary
        assert rb.write(x) == 300
        np.testing.assert_array_equal(rb.read(300), x)
    rb.close()


def test_ring_buffer_overflow_drops():
    rb = t_rt.NativeRingBuffer(100)
    assert rb.write(np.ones(150, np.complex64)) == 100
    assert rb.size == 100
    rb.close()


@pytest.mark.parametrize("sender", ["port", "jax"])
def test_udp_sample_pipe_loopback(sender):
    """The port's receiver gets the samples bit for bit, from the port's
    sender and from the JAX package's (the same datagrams on the wire)."""
    port = BASE + (0 if sender == "port" else 1)
    rx = t_rt.SamplePipeRx(port, capacity=1 << 16)
    tx = (t_rt if sender == "port" else j_rt).SamplePipeTx("127.0.0.1", port)
    x = cnoise(1, 10_000)
    assert tx.send(x) == 10_000
    y = rx.read(10_000, timeout_ms=2000)
    tx.close()
    rx.close()
    assert len(y) == 10_000
    np.testing.assert_array_equal(y, x)


def test_udp_sample_pipe_to_the_reference():
    """The port's sender to the JAX package's receiver."""
    port = BASE + 2
    rx = j_rt.SamplePipeRx(port, capacity=1 << 16)
    tx = t_rt.SamplePipeTx("127.0.0.1", port)
    x = cnoise(2, 4000)
    assert tx.send(x) == 4000
    y = rx.read(4000, timeout_ms=2000)
    tx.close()
    rx.close()
    np.testing.assert_array_equal(y, x)


def test_udp_pipe_takes_a_whole_20mhz_burst():
    """A subframe at the ZMQ base rate (23040 samples, 184 KB) sent in one
    go arrives whole: the port's receiver asks the kernel for room for it."""
    port = BASE + 3
    rx = t_rt.SamplePipeRx(port)
    tx = t_rt.SamplePipeTx("127.0.0.1", port)
    x = cnoise(3, 4 * 23040)
    assert tx.send(x) == len(x)
    y = rx.read(len(x), timeout_ms=2000)
    tx.close()
    rx.close()
    np.testing.assert_array_equal(y, x)


def test_tti_clock_ticks_and_wait():
    clk = t_rt.TtiClock(interval_us=1000)
    start = clk.now
    assert clk.wait(start + 5, timeout_ms=1000) >= start + 5
    clk.close()


# ----------------------------------------------------------- net source/sink
def test_net_sink_to_source():
    """The port's NetSink to its NetSource and to the JAX package's."""
    from srslte_tpu.phy.io.net import NetSource as JSource
    from srslte_tpu_torch.phy.io import NetSink, NetSource

    x = cnoise(4, 3000)
    for i, cls in enumerate((NetSource, JSource)):
        src = cls("127.0.0.1", BASE + 4 + i, timeout=2.0)
        sink = NetSink("127.0.0.1", BASE + 4 + i)
        sink.write(x)
        y = src.read(3000)
        sink.close()
        src.close()
        np.testing.assert_array_equal(y, x)


# ------------------------------------------------------------------ radios
def test_file_radio_roundtrip(tmp_path):
    """The analog of tests/test_measure_radio.py::test_file_radio_roundtrip,
    and the JAX package's FileRadio reads what the port's wrote."""
    from srslte_tpu.radio import FileRadio as JFileRadio
    from srslte_tpu_torch.radio import FileRadio

    p = str(tmp_path / "cap.bin")
    x = cnoise(2, 5000)
    tx = FileRadio(tx_path=p)
    tx.tx(x)
    tx.close()
    rx = FileRadio(rx_path=p)
    y, ts = rx.rx_now(5000)
    assert ts.sample_count == 0 and ts.seconds == 0.0
    np.testing.assert_array_equal(y, x)
    y2, ts2 = rx.rx_now(100)  # EOF -> zero padded
    assert ts2.sample_count == 5000 and np.all(y2 == 0)
    rx.close()
    jrx = JFileRadio(rx_path=p)
    np.testing.assert_array_equal(jrx.rx_now(5000)[0], x)
    jrx.close()


def bandlimited(seed, n, used):
    rng = np.random.default_rng(seed)
    xf = np.zeros(n, np.complex64)
    xf[:used] = rng.standard_normal(used) + 1j * rng.standard_normal(used)
    return np.fft.ifft(xf).astype(np.complex64)


@pytest.mark.parametrize("base,cell,n", [(23_040_000, 1_920_000, 1920),
                                         (23_040_000, 30_720_000, 30720)])
def test_pipe_radio_loopback_with_resampling(base, cell, n):
    """The analog of tests/test_measure_radio.py::
    test_pipe_radio_loopback_with_resampling, and one 20 MHz subframe at the
    ZMQ base rate; the resampling runs on the radio's device (the CPU here).
    A burst that does not arrive whole is sent again on a fresh port, as the
    reference's test does."""
    from srslte_tpu_torch.radio import PipeRadio

    x = bandlimited(3, n, n // 20)
    for attempt in range(4):
        port = BASE + 10 + 4 * (cell == 30_720_000) + attempt
        radio = PipeRadio(rx_port=port, tx_port=port, base_srate=base, cell_srate=cell,
                          device="cpu")
        radio.tx(x)
        y, ts = radio.rx_now(n)
        radio.close()
        if len(y) == n and np.allclose(y, x, atol=2e-3):
            break
    assert ts.sample_count == 0 and ts.srate == base
    assert len(y) == n and y.dtype == np.complex64
    np.testing.assert_allclose(y, x, atol=2e-3)


def test_pipe_radio_resamples_like_the_reference():
    """What the port's pipe radio puts on the wire is the JAX package's
    resample_fft of the burst (within 1e-5)."""
    import jax.numpy as jnp

    from srslte_tpu.phy.resampling import resample_fft
    from srslte_tpu_torch.radio import PipeRadio

    port = BASE + 20
    rx = t_rt.SamplePipeRx(port)
    radio = PipeRadio(rx_port=BASE + 21, tx_port=port, base_srate=23_040_000,
                      cell_srate=30_720_000, device="cpu")
    x = bandlimited(5, 30720, 2000)
    radio.tx(x)
    y = rx.read(23040, timeout_ms=2000)
    radio.close()
    rx.close()
    want = np.asarray(resample_fft(jnp.asarray(x), 3, 4))
    assert len(y) == 23040
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5)


# -------------------------------------------------------------------- ZMQ
def test_zmq_rf_wire_protocol():
    """REQ/REP CF32 burst exchange, the rf_zmq wire protocol: the port's
    server to the port's client, and the JAX package's server to the port's
    client, bit for bit."""
    pytest.importorskip("zmq")
    import threading

    from srslte_tpu.net.zmq_rf import ZmqTxServer as JServer
    from srslte_tpu_torch.net.zmq_rf import ZmqRxClient, ZmqTxServer

    burst = cnoise(0, 1920)
    for i, server in enumerate((ZmqTxServer, JServer)):
        addr = f"tcp://127.0.0.1:{BASE + 30 + i}"
        srv = server(bind=addr)
        cli = ZmqRxClient(connect=addr)
        th = threading.Thread(target=lambda: srv.serve_once(burst))
        th.start()
        got = cli.recv()
        th.join()
        srv.close()
        cli.close()
        assert got is not None and got.dtype == np.complex64
        np.testing.assert_array_equal(got, burst)


def test_zmq_rf_raises_without_pyzmq(monkeypatch):
    """Without pyzmq the transport raises when it is built, and nothing
    else is tried."""
    import srslte_tpu_torch.net.zmq_rf as zr

    monkeypatch.setattr(zr, "zmq", None)
    for cls, kw in ((zr.ZmqTxServer, {"bind": "tcp://127.0.0.1:1"}),
                    (zr.ZmqRxClient, {"connect": "tcp://127.0.0.1:1"})):
        with pytest.raises(RuntimeError, match="pyzmq"):
            cls(**kw)
