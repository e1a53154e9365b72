"""Carry decoder state from the JAX package across to this one.

The system has no trained weights.  What takes their place is the static
tables of a bucket, which each package builds itself (the tests hold them
equal), and the resumable turbo-decoder state.  The functions here take the
JAX package's objects as numpy arrays (the caller does the ``np.asarray``)
and return this package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import as_tensor, resolve
from .phy.fec.tdec import TurboState, _tail_beta


def apr_from_numpy(apr, device=None) -> torch.Tensor:
    """Decoder-1 a-priori LLRs [B, K], as returned by the JAX package's
    ``turbo_decode(..., return_state=True)``, for
    ``tdec.turbo_decode(..., apr0=...)``."""
    return as_tensor(np.asarray(apr, np.float32), resolve(device))


def turbo_state_from_numpy(sys, par1, par2, tails, e1, ext2, sc=1.0,
                           device=None) -> TurboState:
    """A `tdec.TurboState` from the pieces of the JAX package's state.

    sys, par1, par2 [B, K]: the split dcat LLRs (unscaled float32);
    tails ((t1x, t1z), (t2x, t2z)), each [B, 3]: the tail LLRs;
    e1, ext2 [B, K]: the inter-SISO extrinsics in the JAX state's working
    type, scaled by `sc` there (1.0 on its float32 path); they come out
    unscaled in float32, the only type this package's state has.
    """
    dev = resolve(device)
    f32 = lambda x: as_tensor(np.asarray(x, np.float32), dev).contiguous()
    (t1x, t1z), (t2x, t2z) = tails
    sc = float(np.asarray(sc, np.float32))
    return TurboState(
        sys=f32(sys), par1=f32(par1), par2=f32(par2),
        b01=_tail_beta(f32(t1x), f32(t1z)), b02=_tail_beta(f32(t2x), f32(t2z)),
        e1=f32(e1) / sc, ext2=f32(ext2) / sc)
