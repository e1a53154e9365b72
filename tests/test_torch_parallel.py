"""Scale-out parity: `srslte_tpu_torch.parallel` against the JAX package, on
the CPU.

Analogs of tests/test_parallel.py and tests/test_time_shard.py.  The port's
mesh is eight virtual shards of the host (`["cpu"] * 8`); the JAX package's
sharded halves run on the conftest's eight virtual CPU devices.  Inputs are
made with numpy from a seed and handed to both packages.  Hard outputs
(bits, CRC flags, BLER, PSS id and offset, the halo's samples) must be
equal; the sharded port must equal the unsharded port bit for bit, its
channel estimate too; samples and estimates are held against the JAX
package's within 1e-5 of their largest magnitude, PSS metrics within 1e-4
relative.  Each JAX chain compiles once (`module` fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import srslte_tpu.parallel as j_par
import srslte_tpu.parallel.time_shard as j_ts
import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.phch.ra as j_ra
import srslte_tpu_torch.parallel as t_par
import srslte_tpu_torch.parallel.time_shard as t_ts
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.phch.ra as t_ra
from srslte_tpu_torch.phy.sync.pss import pss_find_peak, pss_time

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores


@pytest.fixture(autouse=True, scope="module")
def _drop_xla_executables():
    """Drop the JAX package's compiled executables after this file."""
    yield
    jax.clear_caches()


def close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30))


def mesh(axes, n=8):
    return t_par.make_mesh(axes, [CPU] * n)


# ---------------------------------------------------------------- mesh
def test_make_mesh_shapes():
    m, jm = mesh({"carrier": -1}), j_par.make_mesh({"carrier": -1})
    assert m.devices.shape == jm.devices.shape == (8,)
    assert all(d == torch.device(CPU) for d in m.devices)  # a device may repeat
    m2, jm2 = mesh({"host": 2, "carrier": 4}), j_par.make_mesh({"host": 2, "carrier": 4})
    assert m2.axis_names == jm2.axis_names == ("host", "carrier")
    assert m2.devices.shape == jm2.devices.shape == (2, 4)
    assert len(m2.axis_devices("carrier")) == 4 and len(m2.axis_devices("host")) == 2
    assert mesh({"t": 2, "u": -1}, 6).devices.shape == (2, 3)


def test_make_mesh_raises_with_too_few_devices():
    for axes in ({"carrier": 9}, {"host": 2, "carrier": 5}):
        with pytest.raises(ValueError, match="need [0-9]+ devices, have 8") as got:
            mesh(axes)
        with pytest.raises(ValueError) as want:
            j_par.make_mesh(axes)
        assert str(got.value) == str(want.value)


def test_make_mesh_raises_without_a_card(monkeypatch):
    """With no `devices` the mesh is every CUDA device, and with no card it
    raises: nothing is placed on the host unless the caller asks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_par.make_mesh({"t": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        t_par.make_mesh({"t": -1})


def test_shards_split_evenly_or_raise():
    m = mesh({"t": 8})
    x = torch.arange(16.0)
    parts = m.shards(x, "t")
    assert [p.tolist() for p in parts] == [[2.0 * i, 2.0 * i + 1] for i in range(8)]
    assert torch.equal(m.gather(parts, "t"), x)
    with pytest.raises(ValueError, match="split evenly"):
        m.shards(torch.arange(12.0), "t")


# ---------------------------------------------------------------- halo
def test_halo_extend_takes_the_right_neighbours_head():
    """Shard i gets the head of shard i+1 (the last wraps to shard 0), as
    the JAX package's ppermute under shard_map gives it."""
    x = np.arange(8 * 6, dtype=np.float32)
    m = mesh({"t": 8})
    got = [e.numpy() for e in t_par.halo_extend(m.shards(torch.as_tensor(x), "t"), 2)]
    jm = j_par.make_mesh({"t": 8})
    want = np.asarray(shard_map(lambda s: j_par.halo_extend(s, 2, "t"), mesh=jm,
                                in_specs=P("t"), out_specs=P("t"))(jnp.asarray(x)))
    np.testing.assert_array_equal(np.concatenate(got), want)
    for i, e in enumerate(got):
        np.testing.assert_array_equal(e[-2:], x[6 * ((i + 1) % 8):][:2])


def test_sharded_pss_search_matches_unsharded():
    p = t_params.OfdmParams(6)
    rng = np.random.default_rng(4)
    n = 8 * 2048
    m, jm = mesh({"t": 8}), j_par.make_mesh({"t": 8})
    # one PSS inside a shard, one crossing a shard boundary (chunk = 2048)
    for delay, nid2 in ((5555, 1), (3 * 2048 - 60, 2)):
        x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        x[delay : delay + p.symbol_sz] += 3.0 * pss_time(nid2, p.symbol_sz)
        x = x.astype(np.complex64)
        g_n, g_off, g_m = t_par.sharded_pss_search(x, p.symbol_sz, m)
        j_n, j_off, j_m = j_par.sharded_pss_search(jnp.asarray(x), p.symbol_sz, jm)
        assert (int(g_n), int(g_off)) == (int(j_n), int(j_off))
        assert int(g_n) == nid2 and abs(int(g_off) - delay) <= 1
        assert float(g_m) == pytest.approx(float(j_m), rel=1e-4)
        u_n, u_off, _ = pss_find_peak(x, p.symbol_sz, device=CPU)
        assert int(u_n) == nid2 and abs(int(u_off) - int(g_off)) <= 1


def test_sharded_pss_search_needs_an_even_split():
    with pytest.raises(ValueError, match="split evenly"):
        t_par.sharded_pss_search(np.zeros(8 * 2048 + 4, np.complex64), 128, mesh({"t": 8}))


# ---------------------------------------------------------------- pipeline
def test_sharded_dl_pipeline_matches_single_device():
    jcell, tcell = j_params.Cell(n_prb=6, id=3), t_params.Cell(n_prb=6, id=3)
    jpipe = j_par.ShardedDlPipeline(jcell, j_ra.DlGrant.full(6, 5))
    tpipe = t_par.ShardedDlPipeline(tcell, t_ra.DlGrant.full(6, 5))
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (8, 2, tpipe.tbs)).astype(np.uint8)
    close(tpipe.encode(bits[:1], device=CPU), jpipe.encode(jnp.asarray(bits[:1])))

    out_s, ok_s, bler_s = tpipe.jit_e2e(mesh({"carrier": 8}))(bits)
    assert bool(ok_s.all()) and float(bler_s) == 0.0
    np.testing.assert_array_equal(out_s.numpy(), bits)
    out_1, ok_1, bler_1 = tpipe.e2e(bits, device=CPU)  # single device
    assert torch.equal(out_s, out_1) and torch.equal(ok_s, ok_1) and float(bler_1) == 0.0
    j_out, j_ok, j_bler = jpipe.jit_e2e(j_par.make_mesh({"carrier": 8}))(jnp.asarray(bits))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(ok_s.numpy(), np.asarray(j_ok))
    assert float(bler_s) == float(j_bler)


def test_sharded_pipeline_bler_is_global(monkeypatch):
    """One carrier whose samples are replaced by noise fails alone: the
    step's BLER is the share over every carrier (1/8), not one shard's."""
    pipe = t_par.ShardedDlPipeline(t_params.Cell(n_prb=6, id=3), t_ra.DlGrant.full(6, 5))
    rng = np.random.default_rng(1)
    bits = torch.as_tensor(rng.integers(0, 2, (8, 1, pipe.tbs)).astype(np.uint8))
    encode = t_par.ShardedDlPipeline.encode

    def noise_on_carrier_5(self, b, device=None):
        s = encode(self, b, device)
        if torch.equal(b, bits[5:6]):
            s = torch.as_tensor(rng.standard_normal(s.shape).astype(np.complex64))
        return s

    monkeypatch.setattr(t_par.ShardedDlPipeline, "encode", noise_on_carrier_5)
    _, ok, bler = pipe.jit_e2e(mesh({"carrier": 8}))(bits)
    assert ok[:, 0].tolist() == [True] * 5 + [False] + [True] * 2
    assert float(bler) == pytest.approx(1 / 8)


# ---------------------------------------------------------------- time shard
def fading(x, rng, taps=(1.0, 0.45 * np.exp(0.8j), 0.25 * np.exp(-1.9j)), noise=0.02):
    """tests/test_time_shard.py:_fading on the host."""
    y = np.zeros_like(x)
    for d, t in enumerate(taps):
        y[..., d:] += t * x[..., : x.shape[-1] - d]
    y = y + noise * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    return y.astype(np.complex64)


@pytest.fixture(scope="module")
def chains_and_rx():
    jchain = j_ts.TimeShardedDlChain(j_params.Cell(n_prb=15, id=3, nof_ports=1),
                                     j_ra.DlGrant.full(15, 10))
    tchain = t_ts.TimeShardedDlChain(t_params.Cell(n_prb=15, id=3, nof_ports=1),
                                     t_ra.DlGrant.full(15, 10))
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (16, tchain.tbs)).astype(np.float32)
    jtx = np.asarray(jchain.encode(jnp.asarray(bits)))
    close(tchain.encode(bits, device=CPU), jtx)
    rx = fading(jtx, rng)
    return jchain, tchain, bits, rx, jchain.rx(jnp.asarray(rx))


def test_unsharded_chain_decodes_fading(chains_and_rx):
    _, chain, bits, rx, (j_out, j_ok) = chains_and_rx
    out, ok = chain.rx(rx, device=CPU)
    assert bool(ok.all()) and np.array_equal(out.numpy(), bits)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_time_sharded_bit_exact_on_fading(chains_and_rx, n_dev):
    """The sharded chain (the chest halo copied between shards) matches the
    unsharded one bit for bit on a frequency-selective channel, its channel
    estimate included; over 8 shards also the JAX package's sharded chain."""
    jchain, chain, _, rx, _ = chains_and_rx
    b_ref, ok_ref = chain.rx(rx, device=CPU)
    m = mesh({"t": n_dev}, n_dev)
    b_sh, ok_sh = chain.rx_sharded(rx, m)
    assert torch.equal(ok_ref, ok_sh) and torch.equal(b_ref, b_sh)
    grids = chain._ofdm.rx_sf(torch.as_tensor(rx))
    sf_mod = torch.as_tensor(np.arange(16) % 10)
    h_full = chain._ls_freq(grids, sf_mod)
    assert torch.equal(chain.ce_sharded(rx, m), chain._smooth(h_full, h_full[0], True))
    if n_dev == 8:
        j_b, j_ok = jchain.rx_sharded(jnp.asarray(rx), j_par.make_mesh({"t": 8}))
        np.testing.assert_array_equal(b_sh.numpy(), np.asarray(j_b))
        np.testing.assert_array_equal(ok_sh.numpy(), np.asarray(j_ok))


def test_halo_carries_load_bearing_state(chains_and_rx):
    """The smoothed CE at every block-start subframe genuinely depends on
    the neighbour's LS estimate — a dropped halo would change it; the LS
    and the CE agree with the JAX package's."""
    from srslte_tpu.phy.ofdm import Ofdm

    jchain, chain, _, rx, _ = chains_and_rx
    n_dev, per = 8, rx.shape[0] // 8
    sf_mod = np.arange(rx.shape[0]) % 10
    grids = chain._ofdm.rx_sf(torch.as_tensor(rx))
    h_full = chain._ls_freq(grids, torch.as_tensor(sf_mod))
    ce = chain._smooth(h_full, h_full[0], True)
    j_grids = Ofdm(jchain.cell.ofdm, normalize=True).rx_sf(jnp.asarray(rx))
    j_h = jchain._ls_freq(j_grids, jnp.asarray(sf_mod))
    close(h_full, j_h)
    close(ce, jchain._smooth(j_h, j_h[0], True))
    for s in np.arange(1, n_dev) * per:
        # without the halo a block start would self-prime: ce = h[s]
        assert not torch.allclose(ce[s], h_full[s]), f"halo CE identical at block start {s}"


def test_wrong_halo_direction_is_caught(chains_and_rx, monkeypatch):
    """A halo that travels left (block k primed by block k+1's last
    subframe, the PSS search's direction) changes the CE at every block
    start but the first, and this file's check of the sharded CE sees it."""
    _, chain, _, rx, _ = chains_and_rx
    m = mesh({"t": 8})
    right = chain.ce_sharded(rx, m)
    monkeypatch.setattr(t_ts, "halo_from_left",
                        lambda lasts: [lasts[(k + 1) % len(lasts)] for k in range(len(lasts))])
    left = chain.ce_sharded(rx, m)
    differs = [not torch.equal(left[s], right[s]) for s in range(16)]
    assert differs == [s in (2, 4, 6, 8, 10, 12, 14) for s in range(16)]
