"""NR LDPC and polar parity: the port against the JAX package, on the CPU.

Analogs of tests/test_ldpc.py, tests/test_polar.py, the polar parts of
tests/test_nr_pdcch.py and tests/test_nr_uci_pucch.py, and the LDPC gate of
tests/test_bler_gates.py.  Inputs are made with numpy from a seed and handed
to both packages.  Hard outputs (codewords, decoded bits, parity-check
flags, list candidates in their order) must be equal; the soft-combined LLRs
of the rate recovery within rtol 1e-6.  The JAX halves stay at one or two
compiled shapes: the LDPC decoder at BG1 Zc 32 and BG2 Zc 16 (jitted once
per shape), the polar decoders at N <= 128.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.fec.ldpc as j_ldpc
import srslte_tpu.phy.fec.polar as j_polar
import srslte_tpu_torch.phy.fec.ldpc as t_ldpc
import srslte_tpu_torch.phy.fec.polar as t_polar
from srslte_tpu_torch import _device

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores
eq = np.testing.assert_array_equal


@functools.lru_cache(maxsize=None)
def j_ldpc_decode(bg, zc, n_iter):
    """The reference's decoder, jitted once per (graph, iterations)."""
    g = j_ldpc.LdpcGraph(bg, zc)
    return jax.jit(lambda llr: j_ldpc.ldpc_decode(llr, g, n_iter=n_iter))


def codewords(bg, zc, n, seed):
    """(bits, the port's codewords) of n random blocks."""
    g = t_ldpc.LdpcGraph(bg, zc)
    bits = np.random.default_rng(seed).integers(0, 2, (n, g.k)).astype(np.uint8)
    return bits, t_ldpc.ldpc_encode(bits, g, device=CPU).numpy()


# ------------------------------------------------------------------- LDPC
def test_lifting_sizes():
    zs = t_ldpc.valid_lifting_sizes()
    assert zs == j_ldpc.valid_lifting_sizes()
    assert zs[0] == 2 and zs[-1] == 384 and len(zs) == 51
    assert [t_ldpc.lifting_index(z) for z in zs] == [j_ldpc.lifting_index(z) for z in zs]
    assert t_ldpc.lifting_index(384) == 1 and t_ldpc.lifting_index(208) == 6
    for bg in (1, 2):
        for z in (2, 15, 52, 384):
            jg, tg = j_ldpc.LdpcGraph(bg, z), t_ldpc.LdpcGraph(bg, z)
            eq(tg.shifts, jg.shifts)
            assert tg.p1_inverse_shift == jg.p1_inverse_shift


@pytest.mark.parametrize("bg,zc", [(1, 32), (1, 52), (2, 16), (2, 96)])
def test_encode_satisfies_parity(bg, zc):
    """The port's codewords pass the parity check, and equal the
    reference's at the two shapes the JAX half compiles."""
    g = t_ldpc.LdpcGraph(bg, zc)
    bits, cw = codewords(bg, zc, 3, zc)
    assert cw.shape == (3, g.n_full) and cw.dtype == np.uint8
    if (bg, zc) in ((1, 32), (2, 16)):
        eq(cw, np.asarray(j_ldpc.ldpc_encode(jnp.asarray(bits), j_ldpc.LdpcGraph(bg, zc))))
    assert t_ldpc.ldpc_check(cw, g, device=CPU).all()
    eq(cw[:, : g.k], bits)


def test_check_flags_each_flipped_bit():
    """ldpc_check equals the reference's on codewords with one flipped bit."""
    g = t_ldpc.LdpcGraph(2, 16)
    _, cw = codewords(2, 16, 1, 5)
    bad = np.repeat(cw, 6, axis=0)
    for i, pos in enumerate((0, 100, 159, 160, 500, g.n_full - 1)):
        bad[i, pos] ^= 1
    got = t_ldpc.ldpc_check(bad, g, device=CPU).numpy()
    eq(got, np.asarray(j_ldpc.ldpc_check(jnp.asarray(bad), j_ldpc.LdpcGraph(2, 16))))
    assert not got.any()


def noisy_ldpc(bg, zc, seed):
    """(bits, LLRs) of 4 blocks from clean to failing (noise 0.3, 0.9, 2.6,
    4.0 on +-2), the punctured blocks at 0, some LLRs exactly 0 (the
    zero-counts-as-plus-one sign rule) and one block of equal magnitudes
    (the both-masked second minimum)."""
    rng = np.random.default_rng(bg)
    bits, cw = codewords(bg, zc, 4, seed)
    sigma = np.array([0.3, 0.9, 2.6, 4.0], np.float32)[:, None]
    llr = ((2 * cw.astype(np.float32) - 1) * 2.0
           + sigma * rng.standard_normal(cw.shape)).astype(np.float32)
    llr[:, : 2 * zc] = 0.0  # the punctured blocks are never transmitted
    llr[0, 2 * zc : 3 * zc] = np.sign(llr[0, 2 * zc : 3 * zc]) * 1.5
    llr[1, 5 * zc : 5 * zc + 7] = 0.0
    return bits, llr


@pytest.mark.parametrize("bg,zc", [(1, 32), (2, 16)])
def test_decode_matches_reference(bg, zc):
    """Against the reference's compiled decoder, 10 iterations: the parity
    flags of every block equal, and the hard bits of every block it
    decodes.  (XLA contracts the compiled loop's float32 update into fused
    multiply-adds, so in a block that does not converge the low bits, and
    after some iterations a few hard decisions, differ from the reference's
    operations taken one by one; the port takes them one by one, see the
    next test and ROADMAP.md queue C item 18.)"""
    g = t_ldpc.LdpcGraph(bg, zc)
    bits, llr = noisy_ldpc(bg, zc, bg + 10)
    hj, okj = j_ldpc_decode(bg, zc, 10)(jnp.asarray(llr))
    ht, okt = t_ldpc.ldpc_decode(llr, g, n_iter=10, device=CPU)
    okj = np.asarray(okj)
    eq(okt.numpy(), okj)
    assert okj[0] and not okj[3]
    eq(ht.numpy()[okj], np.asarray(hj)[okj])
    eq(ht.numpy()[0], bits[0])


def test_decode_matches_reference_op_by_op():
    """Against the reference's decoder with jit disabled (its float32
    operations one by one, as written; BG2 at Zc 4 to keep that short), 2
    iterations: the hard bits and flags of every block equal, the failing
    ones too."""
    jg, tg = j_ldpc.LdpcGraph(2, 4), t_ldpc.LdpcGraph(2, 4)
    _, llr = noisy_ldpc(2, 4, 12)
    with jax.disable_jit():
        hj, okj = j_ldpc.ldpc_decode(jnp.asarray(llr), jg, n_iter=2)
    ht, okt = t_ldpc.ldpc_decode(llr, tg, n_iter=2, device=CPU)
    eq(okt.numpy(), np.asarray(okj))
    assert not okt.all()
    eq(ht.numpy(), np.asarray(hj))


def test_decode_awgn():
    """The reference's BG2 Zc 64 case on the port alone: every block decodes."""
    g = t_ldpc.LdpcGraph(2, 64)
    rng = np.random.default_rng(1)
    bits, cw = codewords(2, 64, 4, 2)
    llr = (2 * cw - 1.0) * 2.0 + rng.standard_normal(cw.shape) * 0.9
    llr[:, : 2 * 64] = 0.0
    out, ok = t_ldpc.ldpc_decode(llr.astype(np.float32), g, n_iter=10, device=CPU)
    assert ok.all()
    eq(out.numpy(), bits)


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
def test_rm_tables_equal_reference(rv):
    """Rate-matching tables, including E longer than the circular buffer
    and filler bits, and the reference's validity rules."""
    for bg, zc, e, qm, kf in ((2, 48, 2000, 4, 16), (1, 32, 1600, 2, 40), (2, 16, 2400, 6, 0),
                              (1, 384, 8988, 6, 432)):
        jg, tg = j_ldpc.LdpcGraph(bg, zc), t_ldpc.LdpcGraph(bg, zc)
        idx = t_ldpc.ldpc_rm_indices(tg, e, rv, qm, tg.k - kf)
        eq(idx, j_ldpc.ldpc_rm_indices(jg, e, rv, qm, jg.k - kf))
        assert t_ldpc.rm_k0(tg, rv) == j_ldpc.rm_k0(jg, rv)
        assert idx.min() >= 2 * zc and idx.max() < tg.n_full
        assert not ((idx >= tg.k - kf) & (idx < tg.k)).any()


def test_rm_rx_sums_repeated_positions():
    """E = 3 x the circular buffer: every position arrives three times and
    the rate recovery sums the copies (a scatter-add, not an assignment),
    as the reference's `.at[idx].add` does; the filler prior is -1e4."""
    jg, tg = j_ldpc.LdpcGraph(2, 16), t_ldpc.LdpcGraph(2, 16)
    k_prime = tg.k - 8
    e = 3 * (tg.n_full - 2 * 16 - 8)
    llr = np.random.default_rng(4).standard_normal((2, e)).astype(np.float32)
    got = t_ldpc.ldpc_rm_rx(llr, tg, 2, 2, k_prime, device=CPU).numpy()
    ref = np.asarray(j_ldpc.ldpc_rm_rx(jnp.asarray(llr), jg, 2, 2, k_prime))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    idx = t_ldpc.ldpc_rm_indices(tg, e, 2, 2, k_prime)
    assert np.bincount(idx).max() == 3
    want = np.zeros((2, tg.n_full), np.float32)
    np.add.at(want, (slice(None), idx), llr)
    want[:, k_prime : tg.k] = -1e4
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    combined = t_ldpc.ldpc_rm_rx(llr, tg, 2, 2, k_prime, fill_val=0.0, device=CPU).numpy()
    assert (combined[:, k_prime : tg.k] == 0).all()


def test_rm_roundtrip_and_rv_combining():
    """The reference's test: a heavily punctured rv 0, then rv 2 combined
    into it, decodes; the port's tx and rx equal the reference's."""
    jg, tg = j_ldpc.LdpcGraph(1, 32), t_ldpc.LdpcGraph(1, 32)
    rng = np.random.default_rng(3)
    k_prime = tg.k - 40  # 40 filler bits
    bits = rng.integers(0, 2, (2, tg.k)).astype(np.uint8)
    bits[:, k_prime:] = 0  # fillers
    cw = t_ldpc.ldpc_encode(bits, tg, device=CPU)
    qm, e = 2, 1600

    def tx_llr(rv, seed):
        enc = t_ldpc.ldpc_rm_tx(cw, tg, e, rv, qm, k_prime).numpy()
        eq(enc, np.asarray(j_ldpc.ldpc_rm_tx(jnp.asarray(cw.numpy()), jg, e, rv, qm, k_prime)))
        r = np.random.default_rng(seed)
        return ((2 * enc - 1.0) * 1.2 + r.standard_normal(enc.shape)).astype(np.float32)

    l0, l2 = tx_llr(0, 1), tx_llr(2, 2)
    w = (t_ldpc.ldpc_rm_rx(l0, tg, 0, qm, k_prime, device=CPU)
         + t_ldpc.ldpc_rm_rx(l2, tg, 2, qm, k_prime, device=CPU))
    ref = (j_ldpc.ldpc_rm_rx(jnp.asarray(l0), jg, 0, qm, k_prime)
           + j_ldpc.ldpc_rm_rx(jnp.asarray(l2), jg, 2, qm, k_prime))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    out, ok = t_ldpc.ldpc_decode(w, tg, n_iter=10)
    assert ok.all()
    eq(out.numpy()[:, :k_prime], bits[:, :k_prime])


def test_ldpc_bler_gate():
    """tests/test_bler_gates.py's gate on the port: BG1 Zc 64 at Eb/N0 2 dB,
    zero block errors over 50 trials (12 iterations)."""
    g = t_ldpc.LdpcGraph(1, 64)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (50, g.k)).astype(np.uint8)
    cw = t_ldpc.ldpc_encode(bits, g, device=CPU).numpy().astype(np.float32)
    rate = g.k / (g.n_full - 2 * g.zc)
    sigma = np.sqrt(1.0 / (2.0 * rate * 10 ** (2.0 / 10)))
    llr = (2 * cw - 1) + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr[:, : 2 * g.zc] = 0.0
    out, ok = t_ldpc.ldpc_decode(llr, g, n_iter=12, device=CPU)
    assert (out.numpy() != bits).any(axis=1).sum() == 0


def test_ldpc_tables_are_content_keyed():
    """Two graph objects of one (bg, Zc) share their device tables."""
    t_ldpc.ldpc_decode(np.zeros((1, 52 * 8), np.float32), t_ldpc.LdpcGraph(2, 8), n_iter=1,
                       device=CPU)
    n = len(_device._TABLES)
    t_ldpc.ldpc_decode(np.zeros((3, 52 * 8), np.float32), t_ldpc.LdpcGraph(2, 8), n_iter=1,
                       device=CPU)
    assert len(_device._TABLES) == n


# ------------------------------------------------------------------ polar
def test_polar_tables():
    """The port's copies of polar_q1024.npy and polar_il_pattern.npy and the
    tables built from them equal the reference's."""
    q = t_polar.q1024()
    eq(q, j_polar.q1024())
    assert sorted(q.tolist()) == list(range(1024)) and list(q[:6]) == [0, 1, 2, 4, 8, 16]
    m6 = t_polar.mother_code(6)
    assert len(m6) == 64 and list(m6) == [x for x in q if x < 64]
    for n in (5, 7, 9, 10):
        j = t_polar.blk_interleaver(n)
        eq(j, j_polar.blk_interleaver(n))
        assert sorted(j.tolist()) == list(range(1 << n))
    for k in (20, 39, 63, 64, 140, 164):
        il = t_polar.input_interleaver(k)
        eq(il, j_polar.input_interleaver(k))
        assert sorted(il.tolist()) == list(range(k))


CODES = [(56, 164, 9, False), (32, 100, 9, False), (40, 500, 9, False), (80, 96, 9, False),
         (20, 400, 9, False), (63, 432, 9, False), (20, 240, 10, True), (22, 150, 10, True),
         (18, 120, 10, True), (25, 300, 10, True), (51, 288, 10, True)]


@pytest.mark.parametrize("K,E,n_max,pc", CODES)
def test_construction_equals_reference(K, E, n_max, pc):
    j, t = j_polar.PolarCode(K, E, n_max, pc), t_polar.PolarCode(K, E, n_max, pc)
    assert (t.n, t.N, t.n_pc, t.n_wm_pc) == (j.n, j.N, j.n_pc, j.n_wm_pc)
    for name in ("frozen_mask", "k_set", "pc_set", "pc_matrix", "leaf_kind"):
        eq(getattr(t, name), getattr(j, name))
    if (K, E) == (56, 164):
        assert t.N == 256 and (~t.frozen_mask).sum() == 56


def test_polar_transform_involution():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (4, 128)).astype(np.uint8)
    x = t_polar.polar_transform(torch.as_tensor(u))
    eq(x.numpy(), np.asarray(j_polar.polar_transform(jnp.asarray(u))))
    eq(t_polar.polar_transform(x).numpy(), u)  # G_N is an involution over GF(2)


def noisy_polar(code, bits, rng, amp, sigma):
    """The port's codeword of `bits` through BPSK and AWGN: (codeword, LLRs)."""
    cw = t_polar.polar_encode(bits, code, device=CPU).numpy()
    llr = (2 * cw.astype(np.float32) - 1) * amp + sigma * rng.standard_normal(cw.shape)
    return cw, llr.astype(np.float32)


@pytest.mark.parametrize("K,E", [(32, 100), (56, 164), (40, 500), (80, 96), (20, 400)])
def test_polar_e2e_awgn(K, E):
    """The encoder equals the reference's (puncturing, shortening and
    repetition), the SC decoder too where N <= 128 (the JAX half's size),
    and the blocks decode (the reference's test)."""
    jc, tc = j_polar.PolarCode(K, E), t_polar.PolarCode(K, E)
    rng = np.random.default_rng(K + E)
    bits = rng.integers(0, 2, (4 if E < 400 else 2, K)).astype(np.uint8)
    amp, sigma = (1.0, 1.0) if E == 400 else (2.5, 0.7)
    cw, llr = noisy_polar(tc, bits, rng, amp, sigma)
    assert cw.shape[-1] == E
    eq(cw, np.asarray(j_polar.polar_encode(jnp.asarray(bits), jc)))
    out = t_polar.polar_decode(llr, tc, device=CPU).numpy()
    if tc.N <= 128:
        eq(out, np.asarray(j_polar.polar_decode(jnp.asarray(llr), jc)))
    eq(out, bits)


def test_polar_rm_rx_sums_repetitions():
    """E = 2.5 N: every mother-code position gets the sum of its copies, in
    the reference's order (exactly its float32 values)."""
    jc, tc = j_polar.PolarCode(12, 320), t_polar.PolarCode(12, 320)
    assert tc.N == 128 and tc.E > 2 * tc.N
    llr = np.random.default_rng(6).standard_normal((3, 320)).astype(np.float32)
    got = t_polar.polar_rm_rx(llr, tc, device=CPU).numpy()
    eq(got, np.asarray(j_polar.polar_rm_rx(jnp.asarray(llr), jc)))
    folded = np.zeros((3, 384), np.float32)
    folded[:, :320] = llr
    want = folded.reshape(3, 3, 128).sum(1)
    np.testing.assert_allclose(got[:, t_polar.blk_interleaver(tc.n)], want, rtol=1e-6)


@pytest.mark.parametrize("K,E,n_max,pc", [(40, 108, 9, False), (20, 240, 10, True),
                                          (22, 150, 10, True), (18, 120, 10, True)])
def test_scl_matches_reference(K, E, n_max, pc):
    """List candidates, in their order, equal the reference's on a noisy
    block, and the best of a clean one is the block sent; with PC bits (UL UCI at K 18-25) the PC matrix is the
    reference's 5-slot register and the best candidate is the block sent."""
    jc, tc = j_polar.PolarCode(K, E, n_max, pc), t_polar.PolarCode(K, E, n_max, pc)
    rng = np.random.default_rng(K)
    bits = rng.integers(0, 2, K).astype(np.uint8)
    if pc:
        assert tc.n_pc == 3 and len(tc.pc_set) == 3 and len(tc.k_set) == K
        if E > K + 189:
            assert (252 if K <= 21 else 248) in tc.pc_set
        y5, i_k, reg_pc = [0] * 5, 0, {}
        for p in range(tc.N):
            y5 = y5[1:] + [y5[0]]
            if p in set(tc.k_set.tolist()):
                y5[0] ^= int(bits[i_k])
                i_k += 1
            elif p in set(tc.pc_set.tolist()):
                reg_pc[p] = y5[0]
        assert [reg_pc[p] for p in tc.pc_set] == ((bits @ tc.pc_matrix.T) % 2).tolist()
    cw, clean = noisy_polar(tc, bits, rng, 10.0, 0.0)
    eq(cw, np.asarray(j_polar.polar_encode(jnp.asarray(bits), jc)))
    y = (1 - 2 * cw.astype(np.float32)) + 0.6 * rng.standard_normal(E)
    eq(t_polar.polar_decode_list(clean, tc, L=8, device=CPU).numpy()[0], bits)
    llr = (-y * 5).astype(np.float32)
    got = t_polar.polar_decode_list(llr, tc, L=8, device=CPU).numpy()
    eq(got, np.asarray(j_polar.polar_decode_list(jnp.asarray(llr), jc, L=8)))
    if pc:
        eq(got[0], bits)


@pytest.mark.parametrize("case", ["zeros", "punctured", "quantised"])
def test_scl_ties_follow_top_k(case):
    """Equal path metrics: the reference's `top_k` keeps the lower index
    first among equal values, so an all-zero input, a punctured code whose
    front LLRs are 0, and LLRs of one magnitude (where many metrics tie)
    decide the candidates by that order.  The port's stable sort gives the
    same candidates in the same order."""
    code = (32, 100) if case == "punctured" else (40, 108)
    jc, tc = j_polar.PolarCode(*code), t_polar.PolarCode(*code)
    rng = np.random.default_rng(9)
    if case == "zeros":
        llr = np.zeros(tc.E, np.float32)
    else:
        _, llr = noisy_polar(tc, rng.integers(0, 2, tc.K).astype(np.uint8), rng, 1.0, 1.0)
        if case == "quantised":
            llr = np.where(llr > 0, 2.0, -2.0).astype(np.float32)
            llr[::7] = 0.0
    if case == "punctured":
        assert 16 * tc.K <= 7 * tc.E and tc.E < tc.N  # the first N - E are 0
    got = t_polar.polar_decode_list(llr, tc, L=8, device=CPU).numpy()
    eq(got, np.asarray(j_polar.polar_decode_list(jnp.asarray(llr), jc, L=8)))


def test_scl_equals_sc_at_list_1():
    """The list decoder at L=1, and polar_decode, which is that, give the
    reference's SC recursion's bits."""
    rng = np.random.default_rng(3)
    code = t_polar.PolarCode(K=40, E=108)
    llr = []
    for _ in range(5):
        bits = rng.integers(0, 2, code.K).astype(np.uint8)
        x = t_polar.polar_encode(bits, code, device=CPU).numpy().astype(np.float32)
        llr.append((-((1 - 2 * x) + 0.4 * rng.standard_normal(code.E)) * 8).astype(np.float32))
    llr = np.stack(llr)
    sc = np.asarray(j_polar.polar_decode(jnp.asarray(llr), j_polar.PolarCode(K=40, E=108)))
    eq(t_polar.polar_decode_list(llr, code, L=1, device=CPU).numpy()[:, 0], sc)
    eq(t_polar.polar_decode(llr, code, device=CPU).numpy(), sc)


def test_scl_beats_sc_at_low_snr():
    """List-8 (genie-selected) must dominate plain SC (CA-SCL gain)."""
    rng = np.random.default_rng(7)
    code = t_polar.PolarCode(K=64, E=128)
    sigma = 10 ** (1.0 / 20)  # -1 dB
    bits, llr = [], []
    for _ in range(40):  # the reference's draws, in its order
        b = rng.integers(0, 2, code.K).astype(np.uint8)
        x = t_polar.polar_encode(b, code, device=CPU).numpy().astype(np.float32)
        y = (1 - 2 * x) + sigma * rng.standard_normal(code.E)
        bits.append(b)
        llr.append((-y * 2 / sigma**2).astype(np.float32))
    bits, llr = np.stack(bits), np.stack(llr)
    ok_sc = int((t_polar.polar_decode(llr, code, device=CPU).numpy() == bits).all(1).sum())
    cands = t_polar.polar_decode_list(llr, code, L=8, device=CPU).numpy()  # batch axis
    ok_l = int((cands == bits[:, None, :]).all(-1).any(-1).sum())
    assert ok_l > ok_sc and ok_l >= 10


def test_scl_best_path_first_and_batch_axis():
    """Candidates come metric-sorted (on a clean channel the first is the
    block sent), and a batch decodes as its blocks one by one."""
    rng = np.random.default_rng(11)
    code = t_polar.PolarCode(K=48, E=216)
    bits = rng.integers(0, 2, (3, code.K)).astype(np.uint8)
    x = t_polar.polar_encode(bits, code, device=CPU).numpy().astype(np.float32)
    llr = (-(1 - 2 * x) * 10).astype(np.float32)
    llr[1] += rng.standard_normal(code.E).astype(np.float32) * 8
    batch = t_polar.polar_decode_list(llr, code, L=8, device=CPU).numpy()
    assert batch.shape == (3, 8, code.K)
    eq(batch[0, 0], bits[0])
    for i in range(3):
        eq(batch[i], t_polar.polar_decode_list(llr[i], code, L=8, device=CPU).numpy())
