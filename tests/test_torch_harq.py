"""HARQ soft combining, retransmissions at every rv, and the device Gold
sequence: the port against the JAX package, on the CPU.

The same numpy LLRs go through both packages' `combine_llr` over the rv
cycle 0, 2, 3, 1.  The soft buffers agree to a relative 1e-5 of their scale:
the port's inverse rate matching is a masked gather-sum and the reference's
a scatter-add, so where E exceeds the circular buffer the repeated positions
are summed in another order.  Decoded bits and CRC flags are equal exactly.
The reference runs its float32 path.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.mac.harq as j_harq
import srslte_tpu.phy.common.sequence as j_seq
import srslte_tpu.phy.phch.dlsch as j_dlsch
import srslte_tpu_torch.mac.harq as t_harq
import srslte_tpu_torch.phy.common.sequence as t_seq
import srslte_tpu_torch.phy.phch.dlsch as t_dlsch
from srslte_tpu_torch import convert

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores

# (tbs, G, Qm): a 6 PRB bucket (mcs 27, one code block of K 3776, rate 0.83)
# and a TB of two code blocks of one K in two groups, the first with 56
# filler bits, whose E exceeds the circular buffer (repetition)
CONFIGS = {"6prb_mcs27": (3752, 4536, 6), "two_groups_fillers": (6272, 19416, 2)}


def configs(name, rv=0):
    tbs, G, Qm = CONFIGS[name]
    return j_dlsch.DlschConfig(tbs, G, Qm, rv=rv), t_dlsch.DlschConfig(tbs, G, Qm, rv=rv)


def rel_close(got, ref, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def noisy_llr(rng, coded, snr_db):
    """BPSK + AWGN LLRs (positive => bit 1) of coded bits [..., G]."""
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * coded.astype(np.float32)) + sigma * rng.standard_normal(coded.shape)
    return (-y * 2 / sigma**2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def rv_cycle(name, snr_db=-1.0):
    """Two TBs through the rv cycle: per transmission, both packages' soft
    buffers after combining; the bits sent."""
    rng = np.random.default_rng(len(name))
    jcfg0, _ = configs(name)
    bits = rng.integers(0, 2, (2, jcfg0.tbs)).astype(np.uint8)
    js, ts, out = None, None, []
    for rv in j_harq.RV_SEQ:
        jcfg, tcfg = configs(name, rv)
        coded = np.asarray(j_dlsch.dlsch_encode(jnp.asarray(bits), jcfg))
        np.testing.assert_array_equal(t_dlsch.dlsch_encode(bits, tcfg, device=CPU).numpy(),
                                      coded)
        llr = noisy_llr(rng, coded, snr_db)
        js = j_harq.combine_llr(jnp.asarray(llr), jcfg, js)
        ts = t_harq.combine_llr(llr, tcfg, ts, device=CPU)
        out.append((js, ts))
    return bits, out


@functools.lru_cache(maxsize=None)
def j_decode_state(name):
    jcfg, _ = configs(name)
    return jax.jit(lambda st: j_harq.decode_state(st, jcfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_combine_llr_over_the_rv_cycle(name):
    """Soft buffers after each of rv 0, 2, 3, 1 agree to 1e-5 of their scale."""
    _, steps = rv_cycle(name)
    for js, ts in steps:
        assert len(js) == len(ts) == len(configs(name)[1].groups)
        for jw, tw in zip(js, ts):
            assert tw.dtype == torch.float32
            rel_close(tw, jw)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_state(name):
    """decode_state on the buffers after each transmission: bits and CRC
    flags equal to the reference's (its own state decoded), and the TBs
    decoded once enough redundancy has come in."""
    bits, steps = rv_cycle(name)
    _, tcfg = configs(name)
    for js, ts in steps:
        bj, okj = j_decode_state(name)(js)
        bt, okt = t_harq.decode_state(ts, tcfg)
        okj = np.asarray(okj)
        np.testing.assert_array_equal(okt.numpy(), okj)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert okj.all()
    np.testing.assert_array_equal(bt.numpy(), bits)


def test_decode_state_16_bits():
    """With the SISO in 16 bits the same TBs decode to the same bits as in
    float32 (the reference has no CPU path that reaches its bfloat16
    numerics)."""
    _, steps = rv_cycle("two_groups_fillers")
    _, tcfg = configs("two_groups_fillers")
    for _, ts in steps[1:]:
        b32, ok32 = t_harq.decode_state(ts, tcfg)
        b16, ok16 = t_harq.decode_state(ts, tcfg, siso_dtype=torch.bfloat16)
        np.testing.assert_array_equal(ok16.numpy(), ok32.numpy())
        np.testing.assert_array_equal(b16.numpy()[ok32.numpy()], b32.numpy()[ok32.numpy()])


def test_harq_state_from_numpy():
    """A JAX soft buffer carried across: the port decodes it as the
    reference does, and combines the next transmission into it as into its
    own buffer."""
    name = "two_groups_fillers"
    _, steps = rv_cycle(name)
    (js1, ts1), (_, ts2) = steps[1], steps[2]
    st = convert.harq_state_from_numpy(tuple(np.asarray(w) for w in js1), device=CPU)
    assert all(w.dtype == torch.float32 and w.device.type == "cpu" for w in st)
    _, tcfg = configs(name)
    bj, okj = j_decode_state(name)(js1)
    bt, okt = t_harq.decode_state(st, tcfg)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    # rv 3 into the carried buffer and into the port's own: the same sum
    # up to the order of the first combination
    delta = [t2 - t1 for t1, t2 in zip(ts1, ts2)]  # what rv 3 added
    for w_carried, w_own, d in zip(st, ts2, delta):
        rel_close(w_carried + d, w_own)


@pytest.mark.parametrize("rv", [2, 3])
def test_dlsch_decode_at_rv(rv):
    """A retransmission decoded alone at rv 2 and 3, through the cascade and
    the fixed-iteration path: the coded bits are equal, and so are the flags
    and the bits where the CRC passes (rv 1 is in test_torch_fec.py)."""
    jcfg, tcfg = configs("two_groups_fillers", rv)
    rng = np.random.default_rng(rv)
    bits = rng.integers(0, 2, (2, tcfg.tbs)).astype(np.uint8)
    coded = t_dlsch.dlsch_encode(bits, tcfg, device=CPU).numpy()
    np.testing.assert_array_equal(
        coded, np.asarray(jax.jit(lambda b: j_dlsch.dlsch_encode(b, jcfg))(jnp.asarray(bits))))
    llr = noisy_llr(rng, coded, 0.0)
    llr[1] *= 0.05 * rng.standard_normal(tcfg.G)  # one TB beyond repair
    for kw in (dict(n_iter=4), dict(n_iter=3, early=0)):
        bj, okj = jax.jit(lambda x: j_dlsch.dlsch_decode(x, jcfg, **kw))(jnp.asarray(llr))
        bt, okt = t_dlsch.dlsch_decode(llr, tcfg, device=CPU, **kw)
        okj = np.asarray(okj)
        np.testing.assert_array_equal(okt.numpy(), okj)
        assert okj.tolist() == [True, False]
        np.testing.assert_array_equal(bt.numpy()[okj], bits[okj])


def _tx_llr(bits, tcfg, seed, noise=0.79):
    """As tests/test_mac.py: encoded, +-1 with Gaussian noise, ~2 dB Es/N0."""
    rng = np.random.default_rng(seed)
    coded = t_dlsch.dlsch_encode(bits[None], tcfg, device=CPU).numpy()[0]
    llr = (2.0 * coded - 1.0) + rng.standard_normal(len(coded)).astype(np.float32) * noise
    return llr[None].astype(np.float32)


def test_harq_ir_combining_recovers():
    """The analog of tests/test_mac.py::test_harq_ir_combining_recovers: a
    single transmission at rate 0.88 fails at 2 dB, the rv 2 retransmission
    (rate 0.44) passes, a toggled NDI starts a fresh buffer; the port's
    entity and the reference's give the same answers on the same LLRs."""
    rng = np.random.default_rng(0)
    tcfg0 = t_dlsch.DlschConfig(tbs=1384, G=1600, Qm=2, rv=0)
    jcfg0 = j_dlsch.DlschConfig(tbs=1384, G=1600, Qm=2, rv=0)
    bits = rng.integers(0, 2, tcfg0.tbs).astype(np.uint8)
    th, jh = t_harq.DlHarqEntity(), j_harq.DlHarqEntity()

    def both(ndi, b, cfgs, seed):
        llr = _tx_llr(b, cfgs[1], seed)
        ta, tb = th.rx(0, ndi=ndi, llr=llr, cfg=cfgs[1], device=CPU)
        ja, jb = jh.rx(0, ndi=ndi, llr=jnp.asarray(llr), cfg=cfgs[0])
        assert ta == ja
        return ta, tb

    ack1, _ = both(1, bits, (jcfg0, tcfg0), 1)
    assert not ack1
    cfg2 = (dataclasses.replace(jcfg0, rv=2), dataclasses.replace(tcfg0, rv=2))
    ack2, out2 = both(1, bits, cfg2, 2)
    assert ack2
    np.testing.assert_array_equal(out2[0].numpy(), bits)
    assert th.procs[0].state is None  # the soft buffer is freed
    bits3 = rng.integers(0, 2, tcfg0.tbs).astype(np.uint8)
    ack3, _ = both(0, bits3, (jcfg0, tcfg0), 3)
    assert not ack3  # fresh buffer, single punctured tx fails again


def test_ul_harq_rv_cycle():
    """The analog of tests/test_mac.py::test_ul_harq_rv_cycle: rv 0 on a new
    transmission, then 2, 3, 1 on NACKs up to max_retx, as the reference."""
    assert t_harq.RV_SEQ == j_harq.RV_SEQ and t_harq.N_PROC == j_harq.N_PROC
    for h in (t_harq.UlHarqEntity(max_retx=4), j_harq.UlHarqEntity(max_retx=4)):
        ndi, rv = h.new_tx(2, np.ones(100, np.uint8))
        assert (ndi, rv) == (1, 0)
        rvs = []
        while (r := h.retx(2)) is not None:
            rvs.append(r[0])
        assert rvs == [2, 3, 1]
        h.new_tx(3, np.ones(4, np.uint8))
        h.ack(3)
        assert h.retx(3) is None


@pytest.mark.parametrize("seed,length", [(0xABCDE, 200), (0, 31), (2**31 - 1, 1000),
                                         ((0x46 << 14) | 0x1FF, 7)])
def test_gold_sequence_device(seed, length):
    """The analog of tests/test_common.py::test_gold_sequence_jax_matches_host:
    the port's device Gold sequence equals the reference's jitted one and the
    host sequence; a batch of seeds gives each seed's sequence."""
    out = t_seq.gold_sequence_device(torch.tensor(seed), length, device=CPU)
    ref = np.asarray(jax.jit(lambda s: j_seq.gold_sequence_jax(s, length))(np.uint32(seed)))
    assert out.dtype == torch.uint8 and out.shape == (length,)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), t_seq.gold_sequence(seed, length))
    seeds = torch.tensor([[seed, seed ^ 1], [7, 12345]])
    batch = t_seq.gold_sequence_device(seeds, length, device=CPU).numpy()
    assert batch.shape == (2, 2, length)
    for i in range(2):
        for j in range(2):
            np.testing.assert_array_equal(batch[i, j], j_seq.gold_sequence(int(seeds[i, j]), length))
