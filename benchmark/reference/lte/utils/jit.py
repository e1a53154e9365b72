"""Plain stand-in for the port's `utils/jit.py` at commit e4337f4: no graphs.

`lazy_jit` and `stage` return the function itself (with `__wrapped__`), and
`cond` reads its predicate on the host and calls one branch, as the port's
`cond` does eagerly and as a replay of its conditional nodes does.
"""

from __future__ import annotations

import functools


def _identity(fn=None, **_):
    if fn is None:
        return _identity

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper


lazy_jit = _identity
stage = _identity


def cond(pred, true_fn, false_fn, *operands):
    """``true_fn(*operands)`` where the 0-d bool tensor `pred` holds, else
    ``false_fn(*operands)``."""
    return true_fn(*operands) if bool(pred) else false_fn(*operands)
