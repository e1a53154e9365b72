"""The port's cache of device tables is keyed by content.

`srslte_tpu_torch._device.table` keeps every static table it uploads, so a
key that carried a processor object or an RNTI would add entries for each UE
and never free them.  The index tables (the PDSCH RE map, the PUSCH
interleaver, RE map and DMRS, the PUCCH spreading and RE maps) are keyed by
the values they read: same-grant processors for different RNTIs share them.
The tables that do depend on the UE (scrambling sequences, UE-specific
PDCCH gathers) go through `_device.sequence`, whose total size is bounded.
"""

import numpy as np
import pytest
import torch

from srslte_tpu_torch import _device
from srslte_tpu_torch.phy.common.params import Cell
from srslte_tpu_torch.phy.phch.pdcch import Location, Pdcch
from srslte_tpu_torch.phy.phch.pdsch import Pdsch
from srslte_tpu_torch.phy.phch.pucch import Pucch, PucchConfig
from srslte_tpu_torch.phy.phch.pusch import Pusch
from srslte_tpu_torch.phy.phch.ra import DlGrant
from srslte_tpu_torch.phy.phch.ra_ul import UlGrant

CPU = "cpu"
CELL = Cell(n_prb=6, id=42, nof_ports=1)
RNTIS = (0x46, 0x47)

torch.set_num_threads(1)  # several test workers share the machine's cores


@pytest.fixture
def fresh_cache(monkeypatch):
    """Empty caches for the test, the process's own restored after it."""
    monkeypatch.setattr(_device, "_TABLES", {})
    monkeypatch.setattr(_device, "_SEQUENCES", type(_device._SEQUENCES)())


def _bits(n, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 2, n, dtype=np.uint8))


def _pdsch_roundtrip(rnti):
    p = Pdsch(CELL, DlGrant.full(CELL.n_prb, 9), sf_idx=4, cfi=2, rnti=rnti)
    bits = _bits(p.grant.tbs, rnti)
    o = CELL.ofdm
    grid = p.encode(bits, torch.zeros(1, o.nsymb_sf, o.nof_re, dtype=torch.complex64),
                    device=CPU)[0]
    ce = torch.ones(1, o.nsymb_sf, o.nof_re, dtype=torch.complex64)
    out, ok = p.decode(grid, ce, torch.tensor(0.01), device=CPU)
    return bits, out, bool(ok)


def _pusch_roundtrip(rnti):
    p = Pusch(CELL, UlGrant(1, 4, 10), sf_idx=2, rnti=rnti)
    bits = _bits(p.grant.tbs, rnti)
    grid = p.encode(bits, device=CPU)
    out, ok, _ = p.decode(grid, device=CPU)
    return bits, out, bool(ok)


@pytest.mark.parametrize("roundtrip", [_pdsch_roundtrip, _pusch_roundtrip],
                         ids=["pdsch", "pusch"])
def test_same_grant_processors_share_index_tables(fresh_cache, roundtrip):
    """The second RNTI adds no shared table, only its own sequences; each
    decode equals the bits sent and what a cold cache decodes."""
    results = []
    for rnti in RNTIS:
        n_before = len(_device._TABLES)
        seq_before = set(_device._SEQUENCES)
        bits, out, ok = roundtrip(rnti)
        assert ok and torch.equal(out.to(torch.uint8), bits)
        results.append((out, len(_device._TABLES) - n_before,
                        set(_device._SEQUENCES) - seq_before))
    assert results[0][1] > 0  # the first UE built the shared tables
    assert results[1][1] == 0, "a second RNTI with the same grant added shared tables"
    assert results[1][2], "the second RNTI's scrambling sequences were not its own"
    # the shared cache gives what a cold cache gives
    _device._TABLES.clear()
    _device._SEQUENCES.clear()
    assert torch.equal(roundtrip(RNTIS[1])[1], results[1][0])


def test_pucch_tables_shared_across_rntis(fresh_cache):
    """Format 2 carries an RNTI-seeded scrambling (a per-UE sequence); its
    spreading and RE maps are shared."""
    o = CELL.ofdm
    grids = []
    for rnti in RNTIS:
        n_before = len(_device._TABLES)
        p = Pucch(CELL, PucchConfig("2", n_pucch=3), sf_idx=5, rnti=rnti)
        grids.append(p.encode(cqi_bits=(1, 0, 1, 1, 0, 0, 1, 0, 1, 1), device=CPU))
        added = len(_device._TABLES) - n_before
    assert added == 0
    assert grids[0].shape == (o.nsymb_sf, o.nof_re)
    assert not torch.equal(grids[0], grids[1])  # the RNTI's scrambling differs


def test_pdcch_search_tables_are_sequences(fresh_cache):
    """A UE-specific candidate set is a per-UE table: it goes to the bounded
    cache and leaves the shared one alone."""
    p = Pdcch(CELL, 2, 4)
    o = CELL.ofdm
    grid = torch.zeros(o.nsymb_sf, o.nof_re, dtype=torch.complex64)
    ce = torch.ones(1, o.nsymb_sf, o.nof_re, dtype=torch.complex64)
    p._llrs(grid, ce, (Location(0, 2), Location(2, 2)))
    assert not any(k[0][0] in ("pdcch_re", "pdcch_scr") for k in _device._TABLES)
    assert {k[0][0] for k in _device._SEQUENCES} >= {"pdcch_re", "pdcch_scr"}


def test_sequence_cache_is_bounded(fresh_cache, monkeypatch):
    """The least recently used sequences go first once the bound is passed;
    a rebuilt one has the same values."""
    monkeypatch.setattr(_device, "SEQUENCE_BYTES", 3 * 4 * 100)
    build = {s: (lambda s=s: np.full(100, s, np.float32)) for s in range(5)}
    for s in range(3):
        _device.sequence(("s", s), CPU, build[s])
    _device.sequence(("s", 0), CPU, build[0])  # 0 is now the most recent
    _device.sequence(("s", 3), CPU, build[3])  # evicts 1, the least recent
    keys = [k[0][1] for k in _device._SEQUENCES]
    assert keys == [2, 0, 3]
    assert sum(t.numel() * t.element_size() for t in _device._SEQUENCES.values()) <= 1200
    assert torch.equal(_device.sequence(("s", 1), CPU, build[1]), torch.full((100,), 1.0))
