"""The stimulus: the pool of `pool_batches` distinct noisy batches of
subframes that the window sends, and the check's edge batches, made on the
device from the seed with the reference's own transmitter.

Per batch, in this order from one `torch.Generator` on the device: the
transport blocks' bits, the PHICH pattern (where the deployment has a
PHICH), then, after the eNB's grids went through the OFDM modulator and the
channel matrix, complex AWGN at `snr_db` below the batch's mean power per
sample.  The same seed gives the same pool on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Pool:
    """rx [P, B, (nrx,) sf_len] complex64; bits [P, codewords, B, tbs] uint8;
    ack [P, B, ngroups, 8] int64 in {-1: off, 0: NACK, 1: ACK}, or None."""

    rx: torch.Tensor
    bits: torch.Tensor
    ack: torch.Tensor | None

    @property
    def batches(self) -> int:
        return self.rx.shape[0]


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """The generator of `seed`'s stream `stream` (0: the pool, 1: the
    check's edge batches), on the device."""
    if stream:
        seed = int(np.random.SeedSequence([seed % 2**63, stream]).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed % 2**63)
    return g


def transmit(dep, bits, ack):
    """The eNB's subframes for one batch: [B, nports, sf_len]."""
    enb, sf, cfi = dep.enb, dep.sf_idx, dep.cfi
    batch = bits.shape[1]
    g = enb.put_base(enb.empty_grids((batch,), device=bits.device), sf)
    g = enb.put_pcfich(g, sf, cfi)
    if ack is not None:
        g = enb.put_phich(g, sf, ack)
    g = enb.put_pdcch(g, sf, cfi, dep.dci_bits, dep.rnti, dep.tx_loc)
    if dep.codewords == 1:
        g = enb.put_pdsch(g, dep.pdsch, bits[0])
    else:
        g = dep.pdsch.encode2(bits[0], bits[1], g)
    return enb.gen_signal(g)


def awgn(s, snr_db: float, gen):
    """s plus complex AWGN `snr_db` below the mean power of s per sample."""
    sigma = torch.sqrt(torch.mean(torch.abs(s) ** 2) / (10.0 ** (snr_db / 10.0)) / 2.0)
    n = torch.randn((2,) + tuple(s.shape), generator=gen, device=s.device) * sigma
    return s + torch.complex(n[0], n[1])


def make_batches(dep, batch: int, n: int, snr_db: float, gen, device) -> Pool:
    """`n` batches of `batch` subframes at `snr_db`, drawn from `gen` (see
    the module's doc)."""
    codewords = dep.codewords
    tbs = dep.pdsch.cfg.tbs
    rx, bits, acks = [], [], []
    for _ in range(n):
        b = torch.randint(0, 2, (codewords, batch, tbs), generator=gen, device=device,
                          dtype=torch.uint8)
        ack = None
        if dep.phich is not None:
            ack = torch.randint(-1, 2, (batch, dep.phich.ngroups, 8), generator=gen,
                                device=device)
        s = transmit(dep, b, ack)  # [B, nports, sf_len]
        s = s[:, 0] if dep.h is None else torch.einsum("rp,bps->brs", dep.h, s)
        rx.append(awgn(s, snr_db, gen))
        bits.append(b)
        acks.append(ack)
    return Pool(torch.stack(rx), torch.stack(bits),
                None if acks[0] is None else torch.stack(acks))


def make_pool(dep, traffic: dict, seed: int, device) -> Pool:
    """The pool of a cell's traffic mix for `seed`: `pool_batches` batches
    at the mix's `snr_db`."""
    return make_batches(dep, traffic["batch"], traffic["pool_batches"], traffic["snr_db"],
                        generator(seed, device), device)


def make_edge(dep, traffic: dict, seed: int, device, snr_db: float | None = None) -> Pool:
    """The check's edge batches for `seed`: `edge_batches` batches at the
    mix's `edge_snr_db` (or `snr_db`), where many transport blocks sit at
    the turbo decoder's threshold; drawn from a stream of their own, so the
    pool is the same with or without them."""
    snr = traffic["edge_snr_db"] if snr_db is None else snr_db
    return make_batches(dep, traffic["batch"], traffic["edge_batches"], snr,
                        generator(seed, device, stream=1), device)
