"""Control channels and DCI formats against the JAX package on the CPU:
PCFICH, PHICH (normal and extended duration), PDCCH (`search`, `search_all`,
`decode_candidates`) and PBCH at 1, 2 and 4 ports; every DCI format's pack,
unpack, size and grants; the blind search of the compact formats (1B, 1C,
1D) and of the dual-TB formats (2, 2A, 2B) with the PDSCH they schedule.

The same numpy inputs (from seeds) go through both packages.  Grids and
metrics agree to rtol 1e-4 and atol 1e-5 of the signal's scale (float32
products in another order); CFI, DCI hits and payloads, HI decisions on the
sent sequences, MIB bits, decoded bits and CRC flags are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.phch.dci as j_dci
import srslte_tpu.phy.phch.pbch as j_pbch
import srslte_tpu.phy.phch.pcfich as j_pcfich
import srslte_tpu.phy.phch.pdcch as j_pdcch
import srslte_tpu.phy.phch.phich as j_phich
import srslte_tpu.phy.phch.ra as j_ra
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.enb.enb_dl as t_enb
import srslte_tpu_torch.phy.phch.dci as t_dci
import srslte_tpu_torch.phy.phch.pbch as t_pbch
import srslte_tpu_torch.phy.phch.pcfich as t_pcfich
import srslte_tpu_torch.phy.phch.pdcch as t_pdcch
import srslte_tpu_torch.phy.phch.pdsch as t_pdsch
import srslte_tpu_torch.phy.phch.phich as t_phich
import srslte_tpu_torch.phy.ue.ue_dl as t_ue

CPU = "cpu"
PRBS = (6, 15, 25, 50, 75, 100)
torch.set_num_threads(1)  # several test workers share the machine's cores


def close(got, ref, scale=None):
    """rtol 1e-4, atol 1e-5 of the signal's scale."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


def cells(n_prb, cell_id, nof_ports, **kw):
    cp = kw.pop("cp", "norm")
    return (j_params.Cell(n_prb=n_prb, id=cell_id, nof_ports=nof_ports, cp=j_params.CP(cp), **kw),
            t_params.Cell(n_prb=n_prb, id=cell_id, nof_ports=nof_ports, cp=t_params.CP(cp), **kw))


def flat_rx(rng, grids, noise):
    """Per-port grids [..., ports, nsym, nre] through a flat channel per port,
    with noise: (the received grid, the channel as an estimate)."""
    ports = grids.shape[-3]
    h = (np.array([1.0, 0.9, 0.8, 0.85])[:ports]
         * np.exp(1j * rng.uniform(0, 2 * np.pi, ports))).astype(np.complex64)
    rx = np.einsum("p,...psk->...sk", h, grids)
    rx = (rx + cplx(rng, rx.shape, noise)).astype(np.complex64)
    ce = np.ascontiguousarray(np.broadcast_to(h[:, None, None], grids.shape[-3:]))
    return rx, np.broadcast_to(ce, grids.shape).astype(np.complex64)


# ------------------------------------------------------------------ PCFICH
@pytest.mark.parametrize("ports", [1, 2, 4])
def test_pcfich(ports):
    jc, tc = cells(15, 11, ports)
    o = tc.ofdm
    rng = np.random.default_rng(ports)
    for cfi in (1, 2, 3):
        grids = cplx(rng, (2, ports, o.nsymb_sf, o.nof_re), 0.1)
        gj = j_pcfich.Pcfich(jc, 2).encode(jnp.asarray(grids), cfi)
        gt = t_pcfich.Pcfich(tc, 2).encode(torch.as_tensor(grids), cfi)
        close(gt, gj)
        rx, ce = flat_rx(rng, gt.numpy(), 0.05)
        cj, conf_j = j_pcfich.Pcfich(jc, 2).decode(jnp.asarray(rx), jnp.asarray(ce))
        ct, conf_t = t_pcfich.Pcfich(tc, 2).decode(torch.as_tensor(rx), torch.as_tensor(ce))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert (ct == cfi).all()
        close(conf_t, conf_j)


# ------------------------------------------------------------------- PHICH
@pytest.mark.parametrize("ports", [1, 2, 4])
@pytest.mark.parametrize("length", ["norm", "ext"])
def test_phich(ports, length):
    """Every group and sequence with a random ACK / NACK / off pattern,
    normal and extended duration (3 REGs in symbols 0-2)."""
    jc, tc = cells(25, 5, ports, phich_length=length)
    o = tc.ofdm
    jp, tp = j_phich.Phich(jc, 4), t_phich.Phich(tc, 4)
    np.testing.assert_array_equal(tp.re_idx, jp.re_idx)
    assert tp.ngroups == jp.ngroups
    rng = np.random.default_rng(ports * 7 + len(length))
    ack = rng.integers(-1, 2, (2, tp.ngroups, 8)).astype(np.int32)
    grids = cplx(rng, (2, ports, o.nsymb_sf, o.nof_re), 0.1)
    gj = jp.encode(jnp.asarray(grids), jnp.asarray(ack))
    gt = tp.encode(torch.as_tensor(grids), torch.as_tensor(ack))
    close(gt, gj)
    # EnbDl.put_phich is the same call
    close(t_enb.EnbDl(tc).put_phich(torch.as_tensor(grids), 4, torch.as_tensor(ack)), gj)
    rx, ce = flat_rx(rng, tp.encode(torch.zeros_like(torch.as_tensor(grids)),
                                    torch.as_tensor(ack)).numpy(), 0.02)
    hj, mj = jp.decode(jnp.asarray(rx), jnp.asarray(ce))
    ht, mt = tp.decode(torch.as_tensor(rx), torch.as_tensor(ce))
    close(mt, mj)
    on = ack >= 0
    np.testing.assert_array_equal(ht.numpy()[on], np.asarray(hj)[on])
    assert (ht.numpy() == (ack == 1))[on].all()
    # the sent sequences' metrics are +-1 (BPSK scaled back), the off ones 0
    assert np.all(np.abs(np.abs(mt.numpy()[on]) - 1.0) < 0.2)
    assert np.all(np.abs(mt.numpy()[~on]) < 0.2)


# ------------------------------------------------------------------- PDCCH
@pytest.mark.parametrize("ports", [1, 2, 4])
def test_pdcch_search(ports):
    """A DCI 1A at an L=2 UE-specific location in one subframe: the grids,
    `search`, `search_all` (every aligned L=1/2/4/8 candidate) and
    `decode_candidates` of both packages; a wrong RNTI finds nothing."""
    jc, tc = cells(25, 33, ports)
    o = tc.ofdm
    rnti, sf, cfi = 0x5A5, 6, 2
    jpd, tpd = j_pdcch.Pdcch(jc, cfi, sf), t_pdcch.Pdcch(tc, cfi, sf)
    assert tpd.n_cce == jpd.n_cce
    loc = [l for l in t_pdcch.ue_locations(tpd.n_cce, rnti, sf) if l.L == 2][0]
    jloc = j_pdcch.Location(loc.cce, loc.L)
    dci = t_dci.Dci1A(rb_start=3, l_crb=10, mcs=12, harq_pid=2, ndi=1)
    payload = t_dci.pack_format1a(dci, 25)
    rng = np.random.default_rng(ports)
    grids = cplx(rng, (ports, o.nsymb_sf, o.nof_re), 0.05)
    gj = jpd.encode(jnp.asarray(grids), payload, rnti, jloc)
    gt = tpd.encode(torch.as_tensor(grids), payload, rnti, loc)
    close(gt, gj)
    rx, ce = flat_rx(rng, gt.numpy(), 0.03)
    rxj, cej, rxt, cet = jnp.asarray(rx), jnp.asarray(ce), torch.as_tensor(rx), torch.as_tensor(ce)
    as_pairs = lambda hits: [((l.cce, l.L), b.tolist()) for l, b in hits]
    hits_t = tpd.search(rxt, cet, rnti, len(payload))
    assert as_pairs(hits_t) == as_pairs(jpd.search(rxj, cej, rnti, len(payload)))
    assert ((loc.cce, loc.L), payload.tolist()) in as_pairs(hits_t)
    assert tpd.search(rxt, cet, 0x111, len(payload)) == []
    Ls = (1, 2, 4, 8)
    assert [(l.cce, l.L) for l in tpd.all_locations(Ls)] == \
        [(l.cce, l.L) for l in jpd.all_locations(Ls)]
    all_t = tpd.search_all(rxt, cet, rnti, len(payload), Ls)
    assert as_pairs(all_t) == as_pairs(jpd.search_all(rxj, cej, rnti, len(payload), Ls))
    assert ((loc.cce, loc.L), payload.tolist()) in as_pairs(all_t)
    cands = tuple(l for l in tpd.all_locations((2,)))
    ok_t, bits_t = tpd.decode_candidates(rxt, cet, cands, len(payload), rnti)
    ok_j, bits_j = jpd.decode_candidates(rxj, cej, tuple(j_pdcch.Location(l.cce, l.L)
                                                          for l in cands), len(payload), rnti)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    assert ok_t.numpy()[cands.index(loc)]


# -------------------------------------------------------------------- PBCH
@pytest.mark.parametrize("ports,cp", [(1, "norm"), (2, "norm"), (4, "norm"), (4, "ext")])
def test_pbch(ports, cp):
    """The MIB burst on 1, 2 or 4 ports (extended CP too), decoded from a
    4-port estimate: every (phase, ports) hypothesis tried, the port count
    found."""
    jc, tc = cells(50, 17, ports, cp=cp)
    o = tc.ofdm
    jm, tm = j_pbch.Mib(50, "norm", "1", 9), t_pbch.Mib(50, "norm", "1", 9)
    grids = np.zeros((ports, o.nsymb_sf, o.nof_re), np.complex64)
    gj = j_pbch.Pbch(jc).encode_frame(jm, jnp.asarray(grids))
    gt = t_pbch.Pbch(tc).encode_frame(tm, torch.as_tensor(grids))
    close(gt, gj)
    rx, ce = flat_rx(np.random.default_rng(ports), gt.numpy(), 0.01)
    ce4 = np.concatenate([ce, np.ones((4 - ports,) + ce.shape[1:], np.complex64)])
    jcell4 = j_params.Cell(n_prb=50, id=17, nof_ports=4, cp=j_params.CP(cp))
    tcell4 = t_params.Cell(n_prb=50, id=17, nof_ports=4, cp=t_params.CP(cp))
    rj = j_pbch.Pbch(jcell4).decode(jnp.asarray(rx), jnp.asarray(ce4))
    rt = t_pbch.Pbch(tcell4).decode(torch.as_tensor(rx), torch.as_tensor(ce4))
    assert rt[0] and bool(rj[0]) and rt[2:] == tuple(rj[2:]) == (1, ports)
    np.testing.assert_array_equal(rt[1], np.asarray(rj[1]))
    assert t_pbch.Mib.unpack(rt[1]).sfn == 8


# --------------------------------------------------------------------- DCI
def dci_pair(name, **fields):
    return getattr(j_dci, name)(**fields), getattr(t_dci, name)(**fields)


def grant_fields(g):
    return (g.prb_mask, g.prb_mask_slot1, g.mcs, g.rv, g.tbs, g.modulation.name)


@pytest.mark.parametrize("n_prb", PRBS)
def test_dci_formats(n_prb):
    """Every format's pack (bit for bit), unpack and grants at 2 and 4
    ports (and 1 where the size depends on it)."""
    rbg = j_ra.rbg_size(n_prb)
    n_rbg = -(-n_prb // rbg)
    cases = [
        ("Dci0", dict(rb_start=2, l_crb=3, mcs_rv=11, ndi=1, tpc=2, dmrs_cshift=4),
         "format0", ()),
        ("Dci1", dict(rbg_bitmask=0b101, mcs=9, harq_pid=1, rv=1), "format1", ()),
        ("Dci1A", dict(rb_start=1, l_crb=min(4, n_prb - 1), mcs=17, harq_pid=5, ndi=1, rv=2,
                       tpc=3), "format1a", ()),
        ("Dci1B", dict(rb_start=1, l_crb=min(4, n_prb - 1), mcs=11, harq_pid=3, ndi=1, rv=2,
                       tpc=1, tpmi=1, pconf=1), "format1b", (2, 4)),
        ("Dci1D", dict(rb_start=0, l_crb=2, mcs=5, tpmi=1, power_offset=1), "format1d", (2, 4)),
        ("Dci1C", dict(rb_start=1, l_crb=1, mcs=7), "format1c", ()),
    ]
    if n_prb >= 50:
        nv = j_ra.type2_n_vrb_dl(n_prb, True)
        cases.append(("Dci1B", dict(rb_start=2, l_crb=min(6, nv - 2), mcs=9, dist=1),
                      "format1b", (2,)))
    d2 = dict(rbg_bitmask=(1 << n_rbg) - 1, mcs=(17, 12), rv=(1, 3), ndi=(1, 0), harq_pid=5,
              tpc=2, swap=1, pinfo=2)
    for fmt in ("format2", "format2a", "format2b"):
        cases.append(("Dci2", d2, fmt, (2, 4)))
    if n_prb > 10:
        cases.append(("Dci2", dict(rbg_bitmask=(1 << j_ra.type1_nbits(n_prb)) - 1, mcs=(10, 10),
                                   alloc_type=1, rbg_subset=1, shift=1), "format2", (2,)))
    for name, fields, fmt, port_set in cases:
        jd, td = dci_pair(name, **fields)
        for ports in port_set or (None,):
            extra = () if ports is None else (ports,)
            bits = getattr(t_dci, "pack_" + fmt)(td, n_prb, *extra)
            np.testing.assert_array_equal(bits, getattr(j_dci, "pack_" + fmt)(jd, n_prb, *extra))
            got_t = getattr(t_dci, "unpack_" + fmt)(bits, n_prb, *extra)
            got_j = getattr(j_dci, "unpack_" + fmt)(bits, n_prb, *extra)
            assert dataclasses.asdict(got_t) == dataclasses.asdict(got_j), (name, fmt, ports)
        if name == "Dci2":
            for gj, gt in zip(jd.grants(n_prb), td.grants(n_prb)):
                assert grant_fields(gt) == grant_fields(gj)
            assert [td.tb_enabled(q) for q in range(2)] == [jd.tb_enabled(q) for q in range(2)]
        elif name != "Dci0":
            assert grant_fields(td.grant(n_prb)) == grant_fields(jd.grant(n_prb))
    # a disabled TB: (mcs 0, rv 1)
    jd, td = dci_pair("Dci2", rbg_bitmask=1, mcs=(15, 0), rv=(0, 1))
    assert [td.tb_enabled(q) for q in range(2)] == [jd.tb_enabled(q) for q in range(2)] == \
        [True, False]
    # what no valid DCI holds unpacks to None in both
    zeros = np.ones(t_dci.format1c_size(n_prb), np.uint8)
    assert (t_dci.unpack_format1c(zeros, n_prb) is None) == (j_dci.unpack_format1c(zeros, n_prb)
                                                            is None)
    for riv in (0, n_prb * (n_prb + 1) // 2 - 1, n_prb * (n_prb + 1) // 2):
        for nv in (n_prb, n_prb - 1):
            assert t_dci._riv_decode_vrb(riv, n_prb, nv) == j_dci._riv_decode_vrb(riv, n_prb, nv)


def air(tc, grids, H, sf_idx, seed):
    """Grids through the channel matrix H [nrx, ports] with light noise, then
    the port's UeDl.fft_estimate on every rx antenna."""
    enb = t_enb.EnbDl(tc)
    rx = np.einsum("rp,ps->rs", H, enb.gen_signal(grids).numpy())
    rng = np.random.default_rng(seed)
    rx = (rx + cplx(rng, rx.shape, 0.01)).astype(np.complex64)
    return rx, t_ue.UeDl(tc).fft_estimate(torch.as_tensor(rx), sf_idx)


@pytest.mark.parametrize("fmt", ["1b", "1c", "1d"])
def test_blind_search_compact_formats(fmt):
    """The reference's compact-format test at 50 PRB, 2 ports: the eNB sends
    a 1B / 1C / 1D DCI and its PDSCH (SFBC); the blind search of both
    packages on the same grid finds the DCI, and the grant decodes the TB."""
    jc, tc = cells(50, 7, 2)
    rnti, sf_idx, cfi = 0x3C1, 3, 2
    if fmt == "1c":
        jd, td = dci_pair("Dci1C", rb_start=1, l_crb=2, mcs=5)
        payload = t_dci.pack_format1c(td, 50)
        unpack = lambda b: t_dci.unpack_format1c(b, 50)
    else:
        name = "Dci1B" if fmt == "1b" else "Dci1D"
        extra = dict(tpmi=1) if fmt == "1b" else dict(tpmi=1, power_offset=1)
        jd, td = dci_pair(name, rb_start=4, l_crb=6, mcs=8, **extra)
        payload = getattr(t_dci, f"pack_format{fmt}")(td, 50, 2)
        unpack = lambda b: getattr(t_dci, f"unpack_format{fmt}")(b, 50, 2)
    grant = td.grant(50)
    pdsch = t_pdsch.Pdsch(tc, grant, sf_idx, cfi=cfi, rnti=rnti)
    bits = torch.as_tensor(np.random.default_rng(3).integers(0, 2, grant.tbs, dtype=np.uint8))
    pd = t_pdcch.Pdcch(tc, cfi, sf_idx)
    loc = [l for l in t_pdcch.ue_locations(pd.n_cce, rnti, sf_idx) if l.L == 4][0]
    enb = t_enb.EnbDl(tc)
    g = enb.put_pdcch(enb.put_base(enb.empty_grids(device=CPU), sf_idx), sf_idx, cfi, payload,
                      rnti, loc)
    g = enb.put_pdsch(g, pdsch, bits)
    H = np.array([[1.0, 0.8 * np.exp(1.1j)]], np.complex64)
    _, (grid, ce, info) = air(tc, g, H, sf_idx, 7)
    grid, ce = grid[0], ce[0]
    hits = pd.search(grid, ce, rnti, len(payload))
    ref = j_pdcch.Pdcch(jc, cfi, sf_idx).search(jnp.asarray(grid.numpy()),
                                                jnp.asarray(ce.numpy()), rnti, len(payload))
    assert [((l.cce, l.L), b.tolist()) for l, b in hits] == \
        [((l.cce, l.L), b.tolist()) for l, b in ref]
    found = [unpack(b) for l, b in hits if l == loc]
    assert found and found[0] == td
    out, ok = pdsch.decode(grid, ce, info["noise"][0])
    assert bool(ok) and torch.equal(out, bits)


@pytest.mark.parametrize("fmt", ["2", "2a", "2b"])
def test_blind_search_dual_tb_formats(fmt):
    """The reference's dual-TB test at 25 PRB: DCI 2 / 2A / 2B at L=8 and a
    2-layer PDSCH over a 2x2 channel; the blind search on rx 0 of both
    packages finds the DCI, and the grants and pmi rebuilt from it decode
    both TBs through `PdschSm.decode2` on both antennas."""
    jc, tc = cells(25, 9, 2)
    rnti, sf_idx, cfi = 0x777, 4, 2
    n_rbg = -(-25 // j_ra.rbg_size(25))
    jd, td = dci_pair("Dci2", rbg_bitmask=(1 << n_rbg) - 1, mcs=(12, 9),
                      pinfo=(1 if fmt == "2" else 0))
    payload = getattr(t_dci, f"pack_format{fmt}")(td, 25, 2)
    np.testing.assert_array_equal(payload, getattr(j_dci, f"pack_format{fmt}")(jd, 25, 2))
    pd = t_pdcch.Pdcch(tc, cfi, sf_idx)
    loc = [l for l in t_pdcch.ue_locations(pd.n_cce, rnti, sf_idx) if l.L == 8][0]
    g0, g1 = td.grants(25)
    rng = np.random.default_rng(5)
    b0 = torch.as_tensor(rng.integers(0, 2, g0.tbs, dtype=np.uint8))
    b1 = torch.as_tensor(rng.integers(0, 2, g1.tbs, dtype=np.uint8))
    pmi = td.pinfo - 1 if fmt == "2" and td.pinfo else None
    sm = t_pdsch.PdschSm(tc, g0, sf_idx, cfi=cfi, rnti=rnti, pmi=pmi, grant1=g1)
    enb = t_enb.EnbDl(tc)
    g = enb.put_pdcch(enb.put_base(enb.empty_grids(device=CPU), sf_idx), sf_idx, cfi, payload,
                      rnti, loc)
    g = sm.encode2(b0, b1, g)
    H = np.array([[1.0, 0.3 + 0.2j], [0.25 - 0.3j, 0.9]], np.complex64)
    _, (grid, ce, info) = air(tc, g, H, sf_idx, 11)
    hits = pd.search(grid[0], ce[0], rnti, len(payload))
    ref = j_pdcch.Pdcch(jc, cfi, sf_idx).search(jnp.asarray(grid[0].numpy()),
                                                jnp.asarray(ce[0].numpy()), rnti, len(payload))
    assert [((l.cce, l.L), b.tolist()) for l, b in hits] == \
        [((l.cce, l.L), b.tolist()) for l, b in ref]
    found = [getattr(t_dci, f"unpack_format{fmt}")(b, 25, 2) for l, b in hits if l == loc]
    assert found and found[0] == td
    d = found[0]
    r0, r1 = d.grants(25)
    rebuilt = t_pdsch.PdschSm(tc, r0, sf_idx, cfi=cfi, rnti=rnti,
                              pmi=d.pinfo - 1 if fmt == "2" and d.pinfo else None, grant1=r1)
    assert rebuilt == sm
    (o0, ok0), (o1, ok1) = rebuilt.decode2(grid, ce, info["noise"][0])
    assert bool(ok0) and bool(ok1) and torch.equal(o0, b0) and torch.equal(o1, b1)
