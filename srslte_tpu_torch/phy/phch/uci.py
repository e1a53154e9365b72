"""UCI on PUSCH: CQI / RI / HARQ-ACK multiplexed with UL-SCH data
(36.212 §5.2.2.6-5.2.4, C library lib/src/phy/phch/uci.c + sch.c).

Reference behavior:
- Q' resource dimensioning from the beta offsets (36.213 tables 8.6.3-1/2/3,
  sch.c get_beta_{harq,ri,cqi}_offset): Q'_ri/ack = min(ceil(O * M_sc *
  N_symb * beta / K_segm), 4 * M_sc); Q'_cqi = min(ceil((O + L) * ... *
  beta_cqi / K_segm), M_sc * N_symb - Q'_ri) (uci.c Q_prime_cqi:173,
  Q_prime_ri_ack:418).
- Placement in the channel-interleaved stream (uci.c
  uci_ulsch_interleave_{ack,ri}_gen:364/391): group j of RI sits at
  (row = R - 1 - j//4, col = ri_cols[(3j) % 4]) with ri_cols = {1,4,7,10}
  (normal CP); ACK uses {2,3,8,9} and PUNCTURES data.  CQI + data fill the
  remaining matrix row-major and are read column-major.
- 1-bit ACK/RI occupies one Qm-group [o, repetition, placeholder...]; the
  repetition bit equals the previous bit's *scrambled* value and
  placeholders scramble to 1 (uci.c encode_ri_ack:459).  2-bit spans three
  groups [o0,o1] [o2,o0] [o1,o2] with o2 = o0^o1.  CQI <= 11 bits uses the
  (32, O) block code (encode_cqi_short); 12+ bits the CRC8 + tail-biting
  convolutional long form (encode_cqi_long), decoded by the Viterbi kernel.
  3..10-bit ACK/RI use the (32, O) block code cyclically filling every Qm
  bit of the reserved groups (uci.c encode_ack_long).

Every position above is a host-precomputed index array per (grant,
UCI-config) bucket (`uci_plan`), uploaded once per device, so multiplexing is
a few scatters on the encode side and gathers plus small matrix products
(ML detection of 2-bit ACK/RI over the 4-candidate codebook, the CRC8) on the
decode side: no per-bit loops on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..._device import as_tensor
from ..fec.block import _basis, block_decode, block_encode
from ..fec.convolutional import (conv_encode_np, rm_conv_indices, rm_conv_rx,
                                 viterbi_decode)
from ..fec.crc import LTE_CRC8, crc_bits, crc_calc, gf2_matmul

# 36.213 table 8.6.3-1 (HARQ-ACK), -2 (RI), -3 (CQI) beta offsets
BETA_ACK = (2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625, 15.875,
            20.0, 31.0, 50.0, 80.0, 126.0)
BETA_RI = (1.25, 1.625, 2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0,
           12.625, 15.875, 20.0)
BETA_CQI = (None, None, 1.125, 1.25, 1.375, 1.625, 1.75, 2.0, 2.25, 2.5,
            2.875, 3.125, 3.5, 4.0, 5.0, 6.25)

RI_COLS_NORM = (1, 4, 7, 10)
ACK_COLS_NORM = (2, 3, 8, 9)

# bit-value index ((o0, o1, o2) with o2 = o0^o1) carried at bit 0 / bit 1 of
# the j-th 2-bit group, j mod 3 (uci.c encode_ri_ack O_ack==2 branch)
_VAL0 = (0, 2, 1)
_VAL1 = (1, 0, 2)


@dataclass(frozen=True)
class UciCfgUl:
    """UCI payload sizes + beta offset indices for one PUSCH transmission."""

    o_ack: int = 0  # 0..10 HARQ-ACK bits (>2 = block-coded long form)
    o_ri: int = 0  # 0..10 RI bits
    o_cqi: int = 0  # 0..64 CQI/PMI bits (>11 = CRC8+conv long form)
    i_ack: int = 10  # I_offset^HARQ-ACK
    i_ri: int = 7  # I_offset^RI
    i_cqi: int = 8  # I_offset^CQI

    def __post_init__(self):
        # long forms (36.212 §5.2.2.6): 3..10-bit ACK/RI use the (32, O)
        # block code over all Qm bits of the reserved groups; 12+-bit CQI
        # uses CRC8 + tail-biting convolutional coding
        if self.o_ack > 10 or self.o_ri > 10:
            raise ValueError("ACK/RI payloads > 10 bits not defined")
        if self.o_cqi > 64:
            raise ValueError("CQI payloads > 64 bits not supported")

    @property
    def has_uci(self) -> bool:
        return bool(self.o_ack or self.o_ri or self.o_cqi)


def _q_prime_ri_ack(o: int, m_sc: int, n_symb: int, k_segm: int,
                    beta: float) -> int:
    if o == 0:
        return 0
    x = int(np.ceil(o * m_sc * n_symb * beta / k_segm))
    return min(x, 4 * m_sc)


def _q_prime_cqi(o: int, m_sc: int, n_symb: int, k_segm: int, beta: float,
                 q_ri: int) -> int:
    if o == 0:
        return 0
    x = int(np.ceil(o * m_sc * n_symb * beta / k_segm))
    return min(x, m_sc * n_symb - q_ri)


def _group_positions(q: int, r_rows: int, qm: int, cols: tuple) -> np.ndarray:
    """Stream positions (in Qm-groups) of the q UCI groups: col*R + row."""
    j = np.arange(q)
    row = r_rows - 1 - j // 4
    col = np.asarray(cols)[(3 * j) % 4]
    return (col * r_rows + row).astype(np.int64)


@dataclass(frozen=True)
class UciPlan:
    """Host-precomputed multiplexing plan for one (grant, UCI) bucket.

    All index arrays address BITS in the post-interleave (transmitted)
    stream of g_total = m_sc * n_symb * qm bits.
    """

    qm: int
    g_total: int
    q_ri: int  # RI groups
    q_ack: int  # ACK groups
    n_cqi_bits: int  # coded CQI bits at the head of the fill stream
    g_data: int  # UL-SCH coded bits
    fill_bitpos: np.ndarray  # [n_cqi_bits + g_data] scatter: stream[p[i]] = src[i]
    ri_b: np.ndarray  # [q_ri, 2] positions of the 2 payload bits per group
    ri_val: np.ndarray  # [q_ri, 2] which of (o0, o1, o2) goes there
    ack_b: np.ndarray  # [q_ack, 2]
    ack_val: np.ndarray  # [q_ack, 2]
    ack_bits_all: np.ndarray  # [q_ack * qm] every punctured bit position
    rep_pos: np.ndarray  # bits that repeat the previous scrambled bit
    ph_pos: np.ndarray  # bits that scramble to constant 1
    _dev: dict = field(default_factory=dict, compare=False, repr=False)

    def idx(self, name: str, device) -> torch.Tensor:
        """Index array `name` (flattened, int64) on `device`, uploaded once."""
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self, name).reshape(-1).astype(np.int64)).to(device)
            self._dev[key] = t
        return t


@functools.lru_cache(maxsize=None)
def uci_plan(m_sc: int, n_symb: int, qm: int, k_segm: int,
             cfg: UciCfgUl) -> UciPlan:
    r_rows = m_sc  # H''= H'/C_mux rows; C_mux = n_symb columns
    h_total = m_sc * n_symb  # all Qm-groups in the subframe allocation

    q_ri = _q_prime_ri_ack(cfg.o_ri, m_sc, n_symb, k_segm,
                           BETA_RI[cfg.i_ri])
    q_ack = _q_prime_ri_ack(cfg.o_ack, m_sc, n_symb, k_segm,
                            BETA_ACK[cfg.i_ack])
    q_cqi = _q_prime_cqi(cfg.o_cqi, m_sc, n_symb, k_segm,
                         BETA_CQI[cfg.i_cqi], q_ri)

    ri_g = _group_positions(q_ri, r_rows, qm, RI_COLS_NORM)
    ack_g = _group_positions(q_ack, r_rows, qm, ACK_COLS_NORM)

    # CQI + data fill the matrix row-major, skipping RI-reserved entries;
    # entry (row, col) is read out at stream group col*R + row.
    row, col = np.divmod(np.arange(h_total), n_symb)  # row-major order
    gpos = col * r_rows + row
    fill_g = gpos[~np.isin(gpos, ri_g)]
    assert len(fill_g) == h_total - q_ri

    def bits(groups, k):  # bit positions k of each group
        return (groups[:, None] * qm + np.asarray(k)[None, :]).astype(np.int32)

    n_cqi_bits = q_cqi * qm
    g_data = (h_total - q_ri - q_cqi) * qm
    if g_data <= 0:
        raise ValueError("UCI leaves no room for UL-SCH data")

    rep, ph = [], []
    for o, groups in ((cfg.o_ri, ri_g), (cfg.o_ack, ack_g)):
        if o == 1:
            if qm > 1:
                rep.append(groups * qm + 1)
            if qm > 2:
                ph.append(bits(groups, range(2, qm)).reshape(-1))
        elif o == 2 and qm > 2:
            ph.append(bits(groups, range(2, qm)).reshape(-1))
        # o > 2: long form fills every bit of the group with coded bits —
        # no repetition/placeholder fixups

    def valmap(o, q):
        if q == 0:
            return np.zeros((0, 2), np.int32)
        j = np.arange(q)
        if o == 1:
            return np.stack([np.zeros(q), np.zeros(q)], -1).astype(np.int32)
        return np.stack([np.asarray(_VAL0)[j % 3],
                         np.asarray(_VAL1)[j % 3]], -1).astype(np.int32)

    cat = (lambda xs: np.concatenate(xs).astype(np.int32) if xs
           else np.zeros(0, np.int32))

    def payload_bits(o, groups):
        # long form (o > 2) fills every Qm bit of each reserved group
        if o > 2:
            return bits(groups, range(qm))
        return bits(groups, (0, 1) if qm > 1 else (0,))

    return UciPlan(
        qm=qm, g_total=h_total * qm, q_ri=q_ri, q_ack=q_ack,
        n_cqi_bits=n_cqi_bits, g_data=g_data,
        fill_bitpos=bits(fill_g, range(qm)).reshape(-1),
        ri_b=payload_bits(cfg.o_ri, ri_g),
        ri_val=valmap(cfg.o_ri, q_ri),
        ack_b=payload_bits(cfg.o_ack, ack_g),
        ack_val=valmap(cfg.o_ack, q_ack),
        ack_bits_all=bits(ack_g, range(qm)).reshape(-1),
        rep_pos=cat(rep), ph_pos=cat(ph))


def encode_cqi(bits, n_coded: int) -> np.ndarray:
    """Host encoder: CQI payload [..., O] -> coded bits [..., n_coded].

    O <= 11: (32, O) block code; O >= 12: CRC8 + tail-biting convolutional
    long form (uci.c encode_cqi_long)."""
    bits = np.asarray(bits, np.uint8)
    o = bits.shape[-1]
    if o <= 11:
        return block_encode(bits, n_coded)
    payload = np.concatenate([bits, crc_bits(bits, *LTE_CRC8)], axis=-1)
    k = o + 8
    return conv_encode_np(payload)[..., rm_conv_indices(3 * k, n_coded)]


def mux_stream(plan: UciPlan, cqi_data, ri=None, ack=None, device=None):
    """Scatter cqi||data, RI and ACK payload bits into the tx bit stream.

    cqi_data [..., n_cqi_bits + g_data] uint8, ri/ack [o] or [..., o]
    payloads.  Returns the pre-scramble stream [..., g_total]; apply
    scramble_fixups after scrambling.
    """
    cqi_data = as_tensor(cqi_data, device)
    dev = cqi_data.device
    out = torch.zeros(cqi_data.shape[:-1] + (plan.g_total,), dtype=cqi_data.dtype,
                      device=dev)
    out[..., plan.idx("fill_bitpos", dev)] = cqi_data
    for o_bits, name, val in ((ri, "ri_b", plan.ri_val), (ack, "ack_b", plan.ack_val)):
        b = getattr(plan, name)
        if o_bits is None or b.shape[0] == 0:
            continue
        o_bits = as_tensor(o_bits, dev).to(out.dtype)
        o = o_bits.shape[-1]
        if o > 2:
            # long form: (32, O) block code, cyclically filling the groups
            coded = gf2_matmul(o_bits, ("uci_basis", o),
                               lambda: _basis()[:, :o].T).to(out.dtype)
            nb = b.size
            reps = -(-nb // 32)
            seq = coded.repeat((1,) * (coded.dim() - 1) + (reps,))[..., :nb]
            out[..., plan.idx(name, dev)] = seq
            continue
        vec = (o_bits if o == 1 else
               torch.cat([o_bits, o_bits[..., :1] ^ o_bits[..., 1:2]], -1))
        nb = b.shape[1]
        sel = torch.as_tensor(val[:, :nb].reshape(-1).astype(np.int64), device=dev)
        out[..., plan.idx(name, dev)] = vec[..., sel]
    return out


def scramble_fixups(plan: UciPlan, scrambled):
    """Placeholder bits -> 1; repetition bits -> previous scrambled bit
    (a new tensor)."""
    dev = scrambled.device
    scrambled = scrambled.clone()
    if len(plan.ph_pos):
        scrambled[..., plan.idx("ph_pos", dev)] = 1
    if len(plan.rep_pos):
        rep = plan.idx("rep_pos", dev)
        scrambled[..., rep] = scrambled[..., rep - 1]
    return scrambled


def demux_llr(plan: UciPlan, llr_desc, c_seq: np.ndarray, cfg: UciCfgUl,
              device=None):
    """Descrambled stream LLRs -> dict of UCI decisions + data/cqi LLRs.

    c_seq is the host-side Gold bit sequence used for scrambling (needed to
    undo the repetition bits' previous-bit scrambling).  LLR convention:
    positive => bit 1 (matches demod_soft + block_decode).  Keys: "ri",
    "ack", "cqi" (uint8 bits) with "<name>_metric" (float32; for the long
    CQI, 1.0 where its CRC8 passes), and "data_llr" [..., g_data].
    """
    llr_desc = as_tensor(llr_desc, device, torch.float32)
    dev = llr_desc.device
    out = {}
    for name, o, bname, val, q in (("ri", cfg.o_ri, "ri_b", plan.ri_val, plan.q_ri),
                                   ("ack", cfg.o_ack, "ack_b", plan.ack_val, plan.q_ack)):
        if o == 0 or q == 0:
            continue
        b = getattr(plan, bname)
        g = llr_desc[..., plan.idx(bname, dev)]
        if o > 2:
            # long form: fold the group bits onto the (32, O) codeword
            bits_, metric = block_decode(g, o)
            out[name] = bits_
            out[f"{name}_metric"] = metric
            continue
        g = g.reshape(llr_desc.shape[:-1] + b.shape)
        if o == 1:
            s = g[..., 0]
            if b.shape[1] > 1 and len(plan.rep_pos):
                # repetition bit was scrambled by the PREVIOUS bit's c;
                # descrambling used its own c -> re-flip by c[p0]^c[p1]
                p0, p1 = b[:, 0], b[:, 1]
                f = 1.0 - 2.0 * (c_seq[p0] ^ c_seq[p1]).astype(np.float32)
                s = s + g[..., 1] * torch.as_tensor(f, device=dev)
            tot = torch.sum(s, dim=-1)
            out[name] = (tot > 0)[..., None].to(torch.uint8)
            out[f"{name}_metric"] = torch.abs(tot)
        else:
            # ML over the 4 (o0, o1) candidates: correlate the per-value
            # LLR sums against the (o0, o1, o2) patterns
            zero = g.new_zeros(())
            sums = torch.stack([torch.sum(torch.where(torch.as_tensor(val == v, device=dev),
                                                      g, zero), dim=(-1, -2))
                                for v in range(3)], -1)
            cands = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.uint8)
            pat = np.concatenate([cands, cands[:, :1] ^ cands[:, 1:]], 1)
            sc = sums @ torch.as_tensor(1.0 - 2.0 * pat, dtype=torch.float32, device=dev).T
            best = torch.argmin(sc, dim=-1)  # positive LLR = bit 1
            out[name] = torch.as_tensor(cands, device=dev)[best]
            out[f"{name}_metric"] = -torch.min(sc, dim=-1).values

    # ACK groups punctured the data: zero them before de-multiplexing
    if len(plan.ack_bits_all):
        llr_desc = llr_desc.clone()
        llr_desc[..., plan.idx("ack_bits_all", dev)] = 0.0
    src = llr_desc[..., plan.idx("fill_bitpos", dev)]
    if plan.n_cqi_bits:
        cqi_llr = src[..., : plan.n_cqi_bits]
        if cfg.o_cqi <= 11:
            bits, metric = block_decode(cqi_llr, cfg.o_cqi)
            out["cqi"] = bits
            out["cqi_metric"] = metric
        else:
            # long form: de-rate-match + Viterbi (the kernel) + CRC8 check
            k = cfg.o_cqi + 8
            de_rm = rm_conv_rx(cqi_llr, 3 * k)
            flat = de_rm.reshape((-1, de_rm.shape[-1]))
            dec = viterbi_decode(flat, k).reshape(de_rm.shape[:-1] + (k,))
            calc = crc_calc(dec[..., : cfg.o_cqi], *LTE_CRC8)
            crc_ok = torch.all(calc == dec[..., cfg.o_cqi :].to(torch.float32), dim=-1)
            out["cqi"] = dec[..., : cfg.o_cqi]
            out["cqi_metric"] = crc_ok.to(torch.float32)
    out["data_llr"] = src[..., plan.n_cqi_bits :]
    return out
