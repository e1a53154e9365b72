"""Carry decoder state from the JAX package across to this one.

The system has no trained weights.  What takes their place is the static
tables of a bucket, which each package builds itself (the tests hold them
equal), the resumable turbo-decoder state and the HARQ soft buffers.  The
functions here take the JAX package's objects as numpy arrays (the caller
does the ``np.asarray``) and return this package's.  The sidelink
(`phy/sidelink/`) and the scale-out modules (`parallel/`) carry no state
beyond host tables, which each package builds (`tests/test_torch_tables.py`
holds them equal), so nothing here serves them.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import as_tensor, resolve
from .phy.fec.tdec import TurboState, prepare_state


def apr_from_numpy(apr, device=None) -> torch.Tensor:
    """Decoder-1 a-priori LLRs [B, K], as returned by the JAX package's
    ``turbo_decode(..., return_state=True)``, for
    ``tdec.turbo_decode(..., apr0=...)``."""
    return as_tensor(np.asarray(apr, np.float32), resolve(device))


def harq_state_from_numpy(state, device=None) -> tuple:
    """HARQ soft buffers, as returned by the JAX package's
    ``mac.harq.combine_llr`` (a tuple of per-group [..., count, 3(K+4)]
    arrays), for ``mac.harq.combine_llr(..., state=...)`` and
    ``mac.harq.decode_state``."""
    dev = resolve(device)
    return tuple(as_tensor(np.asarray(w, np.float32), dev) for w in state)


def turbo_state_from_numpy(sys, par1, par2, tails, e1, ext2, sc=1.0,
                           sys_d=None, siso_dtype=torch.float32,
                           device=None) -> TurboState:
    """A `tdec.TurboState` from the pieces of the JAX package's state.

    sys, par1, par2 [B, K]: the split dcat LLRs (unscaled float32);
    tails ((t1x, t1z), (t2x, t2z)), each [B, 3]: the tail LLRs;
    e1, ext2 [B, K]: the inter-SISO extrinsics in the JAX state's working
    type (float32 or bfloat16 arrays), scaled by `sc` there;
    sc: the JAX state's scale (1.0 on its float32 path);
    sys_d [B, K]: the JAX state's scaled, unclipped systematic (bfloat16
    path; recomputed from sys and sc when None, which gives the same values).
    siso_dtype: the JAX state's working dtype, as a torch dtype.

    The clipped systematic, the scaled and clipped parities and the
    tail-beta inits are rebuilt here from these by the JAX package's own
    elementwise float32 steps (`tdec.prepare_state`); the window tensors of
    the JAX state carry nothing else.  bfloat16 values cross as float32,
    which holds them exactly.
    """
    dev = resolve(device)
    f32 = lambda x: as_tensor(np.asarray(x, np.float32), dev).contiguous()
    sc = np.float32(sc)
    if siso_dtype == torch.float32 and sc != 1.0:
        raise ValueError(f"the float32 state is unscaled, got sc={sc}")
    (t1x, t1z), (t2x, t2z) = tails
    st = prepare_state(f32(sys), f32(par1), f32(par2),
                       ((f32(t1x), f32(t1z)), (f32(t2x), f32(t2z))),
                       torch.tensor(sc, device=dev), siso_dtype,
                       sys_d=None if sys_d is None else f32(sys_d))
    return st._replace(e1=f32(e1).to(siso_dtype), ext2=f32(ext2).to(siso_dtype))
