"""The turbo BLER gates of tests/test_bler_gates.py on the port's decoder, on
the CPU (the windowed SISO's plain version; the same gates on the card, in
float32 and in 16 bits, are a phase of chip_smoke.py).

lib/src/phy/fec/turbo/test/CMakeLists.txt:45-48 gates the turbo decoder at
ZERO residual errors over 100 AWGN trials at Eb/N0 1.0-2.0 dB for code
blocks 504 and 6144.  The stimulus is the reference test's: the same seeds,
numpy on the host, 6 iterations.  The block error counts equal the JAX
package's on the same LLRs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_tpu.phy.fec.tdec import turbo_decode as j_turbo_decode
from srslte_tpu_torch.phy.fec.tdec import turbo_decode
from srslte_tpu_torch.phy.fec.turbo import turbo_encode_np

torch.set_num_threads(1)  # several test workers share the machine's cores


def turbo_trials(k: int, ebno_db: float, n_trials: int, seed: int):
    """(bits [n, K], dcat LLRs [n, 3(K+4)]) as tests/test_bler_gates.py makes
    them (positive LLR => bit 1)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_trials, k)).astype(np.uint8)
    d = turbo_encode_np(bits).astype(np.float32)
    rate = k / d.shape[-1]
    sigma = np.sqrt(1.0 / (2.0 * rate * 10 ** (ebno_db / 10)))
    llr = (2 * d - 1) + sigma * rng.standard_normal(d.shape).astype(np.float32)
    return bits, llr


def block_errors(k, ebno_db, n_trials, seed):
    bits, llr = turbo_trials(k, ebno_db, n_trials, seed)
    hard, _ = turbo_decode(torch.as_tensor(llr), k, n_iter=6, device="cpu")
    return int((hard.numpy() != bits).any(axis=1).sum())


@pytest.mark.parametrize("k,ebno", [(6144, 1.5), (504, 2.0)])
def test_turbo_bler_gate(k, ebno):
    """Reference gate: 0 block errors / 100 trials at the given Eb/N0."""
    assert block_errors(k, ebno, 100, seed=k) == 0


def test_turbo_fails_well_below_threshold():
    """Far below the waterfall the decoder must not pass, and its block
    errors are the reference's on the same LLRs."""
    errs = block_errors(1024, -2.0, 20, seed=1)
    assert errs > 0
    bits, llr = turbo_trials(1024, -2.0, 20, seed=1)
    hard, _ = j_turbo_decode(jnp.asarray(llr), 1024, n_iter=6)
    assert errs == int((np.asarray(hard) != bits).any(axis=1).sum())
