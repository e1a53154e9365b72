"""The blind receiver from a capture, end to end, against the JAX package.

At 6 PRB on the CPU, as tests/test_e2e_file.py runs the JAX package's
example pair: the port's `make_frame` against the JAX one; the file source
and sink in all three formats; and the port's `receive` against the JAX
`receive` on the same clean and impaired (delay, CFO, noise) streams, which
the port's eNB writes.

Tolerances: the frame's samples agree to rtol 1e-4 and atol 1e-5 of their
scale (float32 IFFTs in another order); everything the receivers decide is
equal: the cell, the MIB, the sync state at every block (subframe index,
stream position), and per subframe the CFI, the DCI, the CRC flag and the
decoded bits.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import examples.pdsch_enodeb as j_enodeb  # noqa: E402
import examples.pdsch_ue as j_ue  # noqa: E402
import srslte_tpu.phy.common.params as j_params  # noqa: E402
import srslte_tpu.phy.io.filesource as j_io  # noqa: E402
import srslte_tpu.phy.ue.ue_sync as j_sync  # noqa: E402
import srslte_tpu_torch.examples.pdsch_enodeb as t_enodeb  # noqa: E402
import srslte_tpu_torch.examples.pdsch_ue as t_ue  # noqa: E402
import srslte_tpu_torch.phy.common.params as t_params  # noqa: E402
import srslte_tpu_torch.phy.io.filesource as t_io  # noqa: E402
import srslte_tpu_torch.phy.ue.ue_sync as t_sync  # noqa: E402

CPU = "cpu"
RNTI = 0x1234
torch.set_num_threads(1)  # several test workers share the machine's cores


@pytest.mark.parametrize("cell_id,mcs,sfn", [(123, 5, 0), (301, 4, 3)])
def test_make_frame_matches_reference(cell_id, mcs, sfn):
    """All 10 subframes (PBCH at frame phase sfn % 4, PSS/SSS, PCFICH,
    PDCCH, PDSCH in every RE-map class) against the JAX example's frame."""
    j_sf, j_bits = j_enodeb.make_frame(j_params.Cell(n_prb=6, id=cell_id, nof_ports=1),
                                       RNTI, mcs, sfn, seed=7)
    t_s, t_bits = t_enodeb.make_frame(t_params.Cell(n_prb=6, id=cell_id, nof_ports=1),
                                      RNTI, mcs, sfn, seed=7, device=CPU)
    np.testing.assert_array_equal(t_bits, j_bits)
    ref = j_sf[..., 0] + 1j * j_sf[..., 1]
    assert t_s.shape == ref.shape and t_s.dtype == torch.complex64
    np.testing.assert_allclose(t_s.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_entry_points_mean_the_card_by_default():
    """With no device named, host data goes to the CUDA device: without one,
    the blind receiver's entry points raise instead of running on the CPU."""
    import srslte_tpu_torch.phy.ue.ue_cell_search as t_cs
    import srslte_tpu_torch.phy.ue.ue_mib as t_mib
    from srslte_tpu_torch.phy.sync.sync import sync_find

    if torch.cuda.is_available():
        return
    cell = t_params.Cell(n_prb=6, id=1, nof_ports=1)
    x = np.zeros(4 * cell.ofdm.sf_len, np.complex64)
    for call in (lambda: t_enodeb.make_frame(cell, RNTI, 5, 0, seed=0),
                 lambda: t_ue.receive(x, 6, RNTI),
                 lambda: t_cs.cell_search(x, cell.ofdm),
                 lambda: sync_find(x[: cell.ofdm.sf_len], cell.ofdm),
                 lambda: t_sync.UeSync(cell).find(x),
                 lambda: t_mib.UeMib(1, 6).decode(x[: cell.ofdm.sf_len])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("fmt", ["complex_float_bin", "complex_short_bin", "float_bin"])
def test_file_source_sink_roundtrip(fmt, tmp_path):
    """The port's sink read back by both packages' sources, and the JAX
    sink read back by the port's, with a seek and a short last read."""
    rng = np.random.default_rng(3)
    x = (0.5 * (rng.standard_normal(1000) + 1j * rng.standard_normal(1000))).astype(np.complex64)
    for sink_mod, name in ((t_io, "port.bin"), (j_io, "jax.bin")):
        sink = sink_mod.FileSink(str(tmp_path / name), fmt)
        sink.write(x[:600])
        sink.write(x[600:])
        sink.close()
    for name in ("port.bin", "jax.bin"):
        got = []
        for src_mod in (t_io, j_io):
            src = src_mod.FileSource(str(tmp_path / name), fmt)
            a = src.read(300)
            src.seek(900)
            b = src.read(500)  # 100 left
            src.close()
            got.append((a, b))
        for a, b in got:
            assert a.dtype == np.complex64 and a.shape == (300,) and b.shape == (100,)
            np.testing.assert_array_equal(a, got[1][0])
            np.testing.assert_array_equal(b, got[1][1])
        if fmt == "complex_float_bin":
            np.testing.assert_array_equal(got[0][0], x[:300])
    with pytest.raises(ValueError):
        t_io.FileSource(str(tmp_path / "port.bin"), "text")


def stream(cell_id, mcs, seed, frames=3):
    """frames frames of the port's eNB at 6 PRB (SFN 0, 1, ...), numpy, and
    the bits of a frame (the same in every frame)."""
    cell = t_params.Cell(n_prb=6, id=cell_id, nof_ports=1)
    out = [t_enodeb.make_frame(cell, RNTI, mcs, sfn=f, seed=seed, device=CPU) for f in range(frames)]
    return torch.cat([s.reshape(-1) for s, _ in out]).numpy(), out[0][1]


def impaired(x):
    """tests/test_e2e_file.py's impairments: 1234 samples of delay, a CFO
    of 0.18 subcarrier, AWGN of 0.02 per part."""
    rng = np.random.default_rng(1)
    x = np.concatenate([np.zeros(1234, np.complex64), x])
    x = x * np.exp(2j * np.pi * 0.18 * np.arange(len(x)) / 128)
    x = x + 0.02 * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


def recording_states(monkeypatch, mod):
    """Record (sf_idx, stream_pos) of the state each track_block starts from."""
    states = []
    track = mod.UeSync.track_block

    def rec(self, samples, state, n_sf, *a, **kw):
        states.append((state.sf_idx, state.stream_pos))
        return track(self, samples, state, n_sf, *a, **kw)

    monkeypatch.setattr(mod.UeSync, "track_block", rec)
    return states


def test_receive_matches_reference(monkeypatch):
    """Both receivers on the clean stream, then on the same stream impaired
    (one cell and grant for both, so the JAX package compiles once)."""
    x, bits = stream(301, 4, 9)
    j_states = recording_states(monkeypatch, j_sync)
    t_states = recording_states(monkeypatch, t_sync)
    for kind, xs in (("clean", x), ("impaired", impaired(x))):
        j_states.clear()
        t_states.clear()
        ref = j_ue.receive(xs, 6, RNTI, max_sf=10)
        got = t_ue.receive(xs, 6, RNTI, max_sf=10, device=CPU)

        assert got["cell"].id == ref["cell"].id == 301, kind
        assert got["mib"] is not None and vars(got["mib"]) == vars(ref["mib"])
        assert got["mib"].n_prb == 6 and got["mib"].sfn % 4 == 0
        assert t_states == j_states and len(t_states) >= 2, kind
        assert len(got["results"]) == len(ref["results"]) >= 10
        for g, r in zip(got["results"], ref["results"]):
            assert (g["sf_idx"], g["cfi"], g["crc_ok"]) == (r["sf_idx"], r["cfi"], r["crc_ok"])
            assert (g["dci"] is None) == (r["dci"] is None)
            if g["dci"] is not None:
                assert vars(g["dci"]) == vars(r["dci"])
                np.testing.assert_array_equal(g["bits"], r["bits"])
        ok = [g for g in got["results"] if g["crc_ok"]]
        assert len(ok) >= (8 if kind == "clean" else 7), kind
        for g in ok:
            np.testing.assert_array_equal(g["bits"], bits[g["sf_idx"]])
