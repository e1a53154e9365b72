"""One CUDA-graph dispatch per call for the package's device entry points.

The counterpart of the JAX package's ``utils/jit.py``, for its two reasons:

- one dispatch per call instead of one launch per operation;
- config objects (frozen dataclasses) are static arguments, so each
  (cell, grant, ...) bucket is captured once.

`lazy_jit` takes the ``static_argnums`` / ``static_argnames`` of
``jax.jit``.  A call's key is its static arguments, by value (as JAX hashes
them; never by object identity), and the shape, dtype and device of every
tensor argument.  The other arguments are traced: tensors and numpy arrays
become tensor inputs, and Python numbers 0-d tensors (bool, int64, float32,
complex64), so that a new value replays the same graph.  Arguments of any
other kind (None, a string, a dtype, ``device=``) are keyed by value.

On a CUDA device the first call of a key runs the function once eagerly on
a side stream (the warm-up builds the kernels, fills the `_device` tables
and the cuFFT plans), then captures it into a ``torch.cuda.CUDAGraph``.
Every call copies its inputs into the graph's static inputs, replays the
graph and returns fresh copies of its outputs, as JAX returns fresh arrays.
A capture that fails raises, naming the entry point and its key: there is
no eager fallback.  On the CPU the function is called directly; so are the
wrapped functions that another one calls while it is warmed up or captured
(they become part of its graph).  ``fn.__wrapped__`` is the eager function.

A function that takes branches on the host from values it reads off the
device (the DL-SCH decoder's early-termination cascade) cannot be one
graph.  ``lazy_jit(segmented=True)`` marks such an entry point: it runs as
Python, and each stage it calls between two reads is a `stage`, a graph of
its own.

The graphs of a device share one memory pool.  A graph's intermediates are
dead once its replay has returned, and so are its outputs once they are
copied out; the only memory it reads that another replay may have written
is its static inputs, which live outside the pool.  So any graph may reuse
what another freed at the end of its capture, whatever the order of the
replays, as long as they run one after another on one stream.  The pool
holds the graphs' outputs plus the largest capture's intermediates.  Graphs
are kept in a least-recently-used cache of at most `GRAPH_BYTES` of static
inputs and outputs, so the pool is bounded too.  A graph holds every
`_device.table` and `_device.sequence` tensor its capture read, and pins
those sequences so that their cache does not drop them while it lives.

The kernel wrappers' launch counters (`count_launches`) count what one
execution of a call launches: a replay adds the launches its graph
captured, and the warm-up and the capture add nothing.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import time
from collections import Counter, OrderedDict

import numpy as np
import torch

from .. import _device

GRAPH_BYTES = 16 * 2**30

_GRAPHS: OrderedDict = OrderedDict()
_COUNTERS: list = []
_LOCAL = threading.local()
_NUMBER_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float32,
                  complex: torch.complex64}
# captures made, their host time and the pool's growth in MB, replays made
STATS = {"captures": 0, "capture_ms": 0.0, "pool_mb": 0.0, "replays": 0}


def _inside() -> bool:
    """True while a graph is warmed up or captured on this thread."""
    return getattr(_LOCAL, "depth", 0) > 0


@contextlib.contextmanager
def _nested():
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


# -- arguments and outputs as trees of leaves ----------------------------------

def _flatten(x, leaves: list):
    """Append x's leaves (in tuples, lists, dicts) to `leaves`; returns its
    structure, hashable."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("namedtuple", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple(x), tuple(_flatten(v, leaves) for v in x.values()))
    leaves.append(x)
    return None


def _unflatten(struct, it):
    if struct is None:
        return next(it)
    if struct[0] == "namedtuple":
        return struct[1](*(_unflatten(s, it) for s in struct[2]))
    if struct[0] == "dict":
        return {k: _unflatten(s, it) for k, s in zip(struct[1], struct[2])}
    items = [_unflatten(s, it) for s in struct[1]]
    return tuple(items) if struct[0] == "tuple" else items


def _is_number(x) -> bool:
    return type(x) in _NUMBER_DTYPES


def _is_traced(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray)) or _is_number(x)


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, str(x.device))
    if isinstance(x, np.ndarray):
        return ("array", x.shape, str(x.dtype))
    if _is_number(x):
        return ("number", type(x))
    return ("value", x)


def _as_input(x, device) -> torch.Tensor:
    """A traced leaf as a tensor on `device` (a new tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return torch.tensor(x, dtype=_NUMBER_DTYPES[type(x)], device=device)


def _fill(static: torch.Tensor, x):
    """Copy a traced leaf into its static input."""
    if isinstance(x, torch.Tensor):
        if x.data_ptr() != static.data_ptr():
            static.copy_(x)
    elif isinstance(x, np.ndarray):
        static.copy_(torch.from_numpy(np.ascontiguousarray(x)))
    else:
        static.fill_(x)


def _fresh(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _nbytes(tensors) -> int:
    """Bytes of the distinct storages of `tensors`."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if isinstance(t, torch.Tensor)}
    return sum(storages.values())


# -- launch counters ---------------------------------------------------------

def count_launches(owner, *attrs: str):
    """Register the launch counters ``owner.<attr>`` of a kernel wrapper
    (an int, or a `collections.Counter` of launches by shape): a replay adds
    to each the launches its graph captured."""
    for a in attrs:
        if (owner, a) not in _COUNTERS:
            _COUNTERS.append((owner, a))


def _copy(v):
    return Counter(v) if isinstance(v, Counter) else v


def _captured_launches(run):
    """run() -> (its result, the launches it made by counter); the
    counters are restored, since a capture launches nothing."""
    before = [_copy(getattr(o, a)) for o, a in _COUNTERS]
    try:
        out = run()
    finally:
        after = [getattr(o, a) for o, a in _COUNTERS]
        for (o, a), v in zip(_COUNTERS, before):
            setattr(o, a, v)
    return out, tuple(y - x for x, y in zip(before, after))


def _replayed_launches(launches):
    for (o, a), n in zip(_COUNTERS, launches):
        if not n:
            continue
        if isinstance(n, Counter):
            getattr(o, a).update(n)
        else:
            setattr(o, a, getattr(o, a) + n)


# -- graphs --------------------------------------------------------------------

class _Graph:
    """One captured call: its graph, static inputs and outputs, the device
    tables it holds, the launches it makes and its memory."""

    def __init__(self, site, graph, inputs, out_struct, outputs, held, pinned, launches,
                 nbytes, capture_ms):
        self.site = site
        self.capture_ms = capture_ms
        self.graph = graph
        self.inputs = inputs
        self.out_struct = out_struct
        self.outputs = outputs
        self.held = held  # the table and sequence tensors the capture read
        self.pinned = pinned
        self.launches = launches
        self.nbytes = nbytes

    def __call__(self, traced):
        for s, x in zip(self.inputs, traced):
            _fill(s, x)
        self.graph.replay()
        _replayed_launches(self.launches)
        STATS["replays"] += 1
        return _unflatten(self.out_struct, iter([_fresh(t) for t in self.outputs]))

    def release(self):
        _device.unpin(self.pinned)
        self.graph.reset()


@functools.lru_cache(maxsize=None)
def _side_stream(device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


@functools.lru_cache(maxsize=None)
def _pool(device):
    """The memory pool of the device's graphs."""
    return torch.cuda.graph_pool_handle()


def _capture(site, key, call_with, traced, device) -> _Graph:
    """Warm up, then capture `call_with(inputs)`; raises on failure.

    The capture goes through ``CUDAGraph.capture_begin`` / ``capture_end``
    on a side stream rather than the ``torch.cuda.graph`` context, which
    collects garbage and empties the allocator's cache at every capture."""
    t0 = time.perf_counter()
    inputs = [_as_input(x, device) for x in traced]
    main = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(main)
    with _nested(), torch.cuda.stream(side):
        _captured_launches(lambda: call_with(inputs))
    torch.cuda.synchronize(device)
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with _nested(), _device.recording() as used, torch.cuda.stream(side):
            graph.capture_begin(pool=_pool(device), capture_error_mode="thread_local")
            try:
                out = call_with(inputs)
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        return out, used

    try:
        (out, used), launches = _captured_launches(capture)
    except Exception as e:
        raise RuntimeError(f"CUDA graph capture of {site.name} failed for key {key}: "
                           f"{type(e).__name__}: {e}") from e
    main.wait_stream(side)
    leaves = []
    out_struct = _flatten(out, leaves)
    grown = max(torch.cuda.memory_reserved(device) - reserved, 0)
    nbytes = _nbytes(inputs) + _nbytes(leaves)
    read = {k: (kind, t) for kind, k, t in used}
    pinned = tuple(k for k, (kind, _) in read.items() if kind == "sequence")
    _device.pin(pinned)
    ms = (time.perf_counter() - t0) * 1e3
    g = _Graph(site.name, graph, inputs, out_struct, leaves,
               tuple(t for _, t in read.values()), pinned, launches, nbytes, ms)
    STATS["captures"] += 1
    STATS["capture_ms"] += ms
    STATS["pool_mb"] += grown / 1e6
    return g


def _insert(key, g: _Graph):
    _GRAPHS[key] = g
    total = sum(v.nbytes for v in _GRAPHS.values())
    while total > GRAPH_BYTES and len(_GRAPHS) > 1:
        _, old = _GRAPHS.popitem(last=False)
        total -= old.nbytes
        old.release()


def graphs(by_site: bool = False) -> dict:
    """The graph cache: {"count": graphs, "mb": their static inputs and
    outputs in MB, **STATS}; with `by_site`, {site: {"count", "mb",
    "capture_ms"}} of the graphs in the cache."""
    if by_site:
        out = {}
        for g in _GRAPHS.values():
            d = out.setdefault(g.site, {"count": 0, "mb": 0.0, "capture_ms": 0.0})
            d["count"] += 1
            d["mb"] += g.nbytes / 1e6
            d["capture_ms"] += g.capture_ms
        return out
    return {"count": len(_GRAPHS), "mb": sum(g.nbytes for g in _GRAPHS.values()) / 1e6,
            **STATS}


def keys() -> list:
    """The keys of the graphs in the cache, least recently used first."""
    return list(_GRAPHS)


@contextlib.contextmanager
def recording_calls():
    """Within: every call of an entry point made outside a graph is
    appended to the list yielded, as (wrapped function, args, kwargs); a
    measurement replays a path's calls one by one from it."""
    _LOCAL.calls = calls = []
    try:
        yield calls
    finally:
        _LOCAL.calls = None


# -- the decorators --------------------------------------------------------------

class _Site:
    """A wrapped function's signature split into static and traced
    arguments."""

    def __init__(self, fn, static_argnums, static_argnames, segmented):
        self.fn = fn
        self.name = f"{fn.__module__}.{fn.__qualname__}"
        self.sig = inspect.signature(fn)
        names = list(self.sig.parameters)
        self.static = frozenset([names[i] for i in static_argnums] + list(static_argnames))
        unknown = self.static - set(names)
        if unknown:
            raise TypeError(f"{self.name} has no arguments {sorted(unknown)}")
        self.segmented = segmented

    def bind(self, args, kwargs) -> inspect.BoundArguments:
        ba = self.sig.bind(*args, **kwargs)
        ba.apply_defaults()
        return ba

    def split(self, ba):
        """(static (name, value) pairs, the leaves of the other arguments,
        their structure)."""
        static, rest = [], []
        for name, v in ba.arguments.items():
            (static if name in self.static else rest).append((name, v))
        leaves = []
        struct = _flatten(tuple(v for _, v in rest), leaves)
        return tuple(static), leaves, struct

    def key(self, ba):
        return self._key(*self.split(ba))

    def _key(self, static, leaves, struct):
        key = (self.name, static, struct, tuple(_leaf_key(x) for x in leaves))
        try:
            hash(key)
        except TypeError as e:
            raise TypeError(f"{self.name}: a static or untraced argument is not "
                            f"hashable: {e}") from e
        return key

    def device(self, ba, leaves) -> torch.device:
        """The device of the call: its first tensor argument's (`leaves`:
        the leaves of `split`), else its ``device=`` argument's (None: the
        CUDA device)."""
        for x in leaves:
            if isinstance(x, torch.Tensor):
                return x.device
        return _device.resolve(ba.arguments.get("device"))

    def traced(self, ba):
        """`ba` with every traced leaf as the tensor the graph takes: what
        the function sees when it is captured."""
        static, leaves, struct = self.split(ba)
        device = self.device(ba, leaves)
        inputs = [_as_input(x, device) if _is_traced(x) else x for x in leaves]
        return self.rebuild(ba, static, struct, inputs)

    def rebuild(self, ba, static, struct, leaves):
        rest = _unflatten(struct, iter(leaves))
        names = [n for n in ba.arguments if n not in self.static]
        args = dict(static)
        args.update(zip(names, rest))
        return inspect.BoundArguments(self.sig, OrderedDict(
            (n, args[n]) for n in ba.arguments))

    def __call__(self, args, kwargs):
        calls = getattr(_LOCAL, "calls", None)
        if calls is not None and self.kind == "entry" and not _inside():
            calls.append((self.wrapper, args, kwargs))
        ba = self.bind(args, kwargs)
        static, leaves, struct = self.split(ba)
        device = self.device(ba, leaves)
        if device.type != "cuda" or self.segmented or _inside():
            return self.fn(*args, **kwargs)
        key = self._key(static, leaves, struct)
        pos = [i for i, x in enumerate(leaves) if _is_traced(x)]
        traced = [leaves[i] for i in pos]
        g = _GRAPHS.get(key)
        if g is None:
            def call_with(inputs):
                full = list(leaves)
                for i, t in zip(pos, inputs):
                    full[i] = t
                b = self.rebuild(ba, static, struct, full)
                return self.fn(*b.args, **b.kwargs)

            g = _capture(self, key, call_with, traced, device)
            _insert(key, g)
        else:
            _GRAPHS.move_to_end(key)
        return g(traced)


def _decorate(fn, static_argnums, static_argnames, segmented, kind):
    if isinstance(static_argnums, int):
        static_argnums = (static_argnums,)
    if isinstance(static_argnames, str):
        static_argnames = (static_argnames,)
    site = _Site(fn, tuple(static_argnums), tuple(static_argnames), segmented)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return site(args, kwargs)

    @functools.wraps(fn)
    def eager(*args, **kwargs):
        with _nested():
            return fn(*args, **kwargs)

    # the eager function: the wrapped ones it calls run as themselves too
    wrapper.__wrapped__ = eager
    wrapper.jit_site = site
    wrapper.jit_kind = site.kind = kind
    site.wrapper = wrapper
    return wrapper


def lazy_jit(fn=None, *, static_argnums=(), static_argnames=(), segmented=False):
    """Decorator: an entry point that replays one CUDA graph per key (see
    the module docstring); ``segmented=True`` for one whose stages are the
    graphs."""
    if fn is None:
        return lambda f: lazy_jit(f, static_argnums=static_argnums,
                                  static_argnames=static_argnames, segmented=segmented)
    return _decorate(fn, static_argnums, static_argnames, segmented, "entry")


def stage(fn=None, *, static_argnums=(), static_argnames=()):
    """Decorator: a stage of a segmented entry point, graphed as `lazy_jit`
    graphs an entry point."""
    if fn is None:
        return lambda f: stage(f, static_argnums=static_argnums, static_argnames=static_argnames)
    return _decorate(fn, static_argnums, static_argnames, False, "stage")


def graph_key(fn, *args, **kwargs):
    """The key a call of the wrapped `fn` would replay under."""
    site = fn.jit_site
    return site.key(site.bind(args, kwargs))


def traced_args(fn, *args, **kwargs):
    """(args, kwargs) of a call of the wrapped `fn` as its graph is
    captured: every traced argument a tensor on the call's device (for
    tests on the CPU, through ``fn.__wrapped__``)."""
    site = fn.jit_site
    b = site.traced(site.bind(args, kwargs))
    return b.args, b.kwargs
