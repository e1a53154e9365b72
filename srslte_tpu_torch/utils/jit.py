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

A branch taken on a value the device computed (the DL-SCH decoder's
early-termination cascade) is a `cond`, the counterpart of
``jax.lax.cond``: eagerly it reads the predicate and calls one branch; in a
capture's warm-up (and under `tracing`, on any device) it calls both and
merges them with ``torch.where``, so that the warm-up builds every table
either branch reads; in a capture each branch becomes the body of a
conditional node that the replay runs when its predicate holds, read on
the card.  So a function with branches is one graph, replayed with no host
read.  A ``lazy_jit(bucket=...)`` entry point rewrites its arguments before
they are keyed (a processor without its RNTI, the RNTI's scrambling
sequence a traced argument), so that the calls it maps together share a
graph.

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
captured outside its conditional bodies, and the warm-up and the capture
add nothing.  A body that launches a counted kernel adds one to a counter
on the card each time a replay runs it; `fold_launches` reads those (one
read for all graphs) and adds each body's launches as many times as it
ran, so the counters equal an eager run's once they are folded.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import inspect
import sys
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
# captures made, their host time and the pool's growth in MB, replays made,
# conditional nodes captured
STATS = {"captures": 0, "capture_ms": 0.0, "pool_mb": 0.0, "replays": 0, "conds": 0}


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


def _replayed_launches(launches, times: int = 1):
    for (o, a), n in zip(_COUNTERS, launches):
        if not n:
            continue
        if isinstance(n, Counter):
            getattr(o, a).update({k: v * times for k, v in n.items()})
        else:
            setattr(o, a, getattr(o, a) + n * times)


def fold_launches():
    """Add to the launch counters the launches of the conditional bodies
    that replays ran since the last fold: one read of the card per device
    (after the replays on the current stream)."""
    _fold(list(_GRAPHS.values()))


def _fold(graphs):
    by_device: dict = {}
    for g in graphs:
        if g.bodies:
            by_device.setdefault(g.counts.device, []).append(g)
    for group in by_device.values():
        runs = torch.cat([g.counts[:len(g.bodies)] for g in group]).tolist()
        for launches, n in zip((b for g in group for b in g.bodies), runs):
            if n:
                _replayed_launches(launches, n)
        torch._foreach_zero_([g.counts for g in group])


# -- conditionals ----------------------------------------------------------------

@contextlib.contextmanager
def tracing():
    """Within, on this thread: every `cond` calls both branches and merges
    their outputs with ``torch.where``, reading nothing back (how a
    capture's warm-up runs a function, and how the CPU tests run it as its
    graph would)."""
    before = getattr(_LOCAL, "tracing", False)
    _LOCAL.tracing = True
    try:
        yield
    finally:
        _LOCAL.tracing = before


def cond(pred, true_fn, false_fn, *operands):
    """``jax.lax.cond``: ``true_fn(*operands)`` where the 0-d bool tensor
    `pred` holds, else ``false_fn(*operands)``.  Both branches return the
    same tree of tensors, of the same shapes and dtypes.

    Eagerly it reads `pred` once and calls one branch.  Under `tracing` (a
    capture's warm-up) it calls both and merges them leaf by leaf.  In a
    capture each branch is the body of a conditional node, one on `pred`
    and one on its negation: the first body copies its outputs into fresh
    tensors and the second writes its own into them, so the replay runs
    one branch and reads nothing back.  A body may hold kernels and copies
    on the card only; conds nest."""
    at = sys._getframe(1)
    if getattr(_LOCAL, "conditional", None) is not None:  # `_capture` is capturing
        return _cond_capture(pred, true_fn, false_fn, operands, at)
    if getattr(_LOCAL, "tracing", False):
        _LOCAL.conds = getattr(_LOCAL, "conds", 0) + 1
        t, f = true_fn(*operands), false_fn(*operands)
        (lt, struct), (lf, _) = _branch_leaves(t, f, at)
        return _unflatten(struct, iter([torch.where(pred, a, b) if isinstance(a, torch.Tensor)
                                        else a for a, b in zip(lt, lf)]))
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def _where(at) -> str:
    return f"jit.cond at {at.f_code.co_filename}:{at.f_lineno} ({at.f_code.co_name})"


def _branch_leaves(t, f, at):
    """((leaves, structure) of each branch's output); raises, naming the
    cond, where the two differ in structure, shape, dtype or device."""
    lt, lf = [], []
    st, sf = _flatten(t, lt), _flatten(f, lf)
    if st != sf:
        raise ValueError(f"{_where(at)}: the branches return different structures: "
                         f"{st} and {sf}")
    for i, (a, b) in enumerate(zip(lt, lf)):
        if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
            raise ValueError(f"{_where(at)}: output {i} is a tensor in one branch only")
        if isinstance(a, torch.Tensor):
            if (a.shape, a.dtype, a.device) != (b.shape, b.dtype, b.device):
                raise ValueError(f"{_where(at)}: output {i} differs between the branches: "
                                 f"{tuple(a.shape)} {a.dtype} {a.device} and "
                                 f"{tuple(b.shape)} {b.dtype} {b.device}")
        elif a is not b and a != b:
            raise ValueError(f"{_where(at)}: output {i} differs between the branches: "
                             f"{a!r} and {b!r}")
    return (lt, st), (lf, sf)


class _Conditional:
    """The graph `_capture` is capturing, as `cond` builds conditional nodes
    in it (`csrc/graph_cond.cu`): the stack of the streams being captured
    (the capture's side stream, then one stream per nested body), the
    graphs' memory pool, to which each body's allocations are routed, and
    the bodies' replay counts.  Those live outside the pool, which lends
    memory to one capture's tensors in turn: `counts` [room] int64, made
    before the capture; `bodies`, the launches of each counted body."""

    launches = 0  # the one-thread kernels that set the handles, as a kernel wrapper's

    def __init__(self, stream, device, pool, mode, counts):
        self.device, self.pool, self.mode = device, pool, mode
        self.streams = [stream]
        self.contexts = []
        self.counts, self.bodies = counts, []

    def _route(self, stream):
        """Allocations on `stream` (only) go to the pool from now on."""
        torch._C._cuda_endAllocateToPool(self.device.index, self.pool)
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(self.device.index, self.pool)

    def begin_if(self, pred, negate: bool):
        """Capture what follows into the body of an IF node on `pred` (a
        bool on the card; `negate`: on its negation)."""
        lib = _cond_lib()
        body = _body_stream(self.device, len(self.streams))
        err = lib.cond_begin_if(self.streams[-1].cuda_stream, pred.data_ptr(), int(negate),
                                body.cuda_stream, lib.cond_capture_mode(self.mode.encode()))
        if err:
            raise RuntimeError(f"a conditional node could not be captured: CUDA error {err}")
        _Conditional.launches += 1
        self._route(body)
        self.streams.append(body)
        ctx = torch.cuda.stream(body)
        ctx.__enter__()
        self.contexts.append(ctx)

    def end_if(self):
        body = self.streams.pop()
        self.contexts.pop().__exit__(None, None, None)
        err = _cond_lib().cond_end_if(body.cuda_stream)
        self._route(self.streams[-1])
        if err:
            raise RuntimeError(f"a conditional body could not be captured: CUDA error {err}")


count_launches(_Conditional, "launches")


@functools.lru_cache(maxsize=None)
def _cond_lib() -> ctypes.CDLL:
    """`csrc/graph_cond.cu`, built at first use."""
    from ..ops import _build

    lib = _build.load("graph_cond")
    lib.cond_begin_if.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int]
    lib.cond_end_if.argtypes = [ctypes.c_void_p]
    lib.cond_capture_mode.argtypes = [ctypes.c_char_p]
    for fn in (lib.cond_begin_if, lib.cond_end_if, lib.cond_capture_mode):
        fn.restype = ctypes.c_int
    return lib


def _body_stream(device, depth: int) -> torch.cuda.Stream:
    """The stream captured into the bodies at nesting depth `depth`."""
    s = BODY_STREAMS.get((device, depth))
    if s is None:
        s = BODY_STREAMS[(device, depth)] = torch.cuda.Stream(device)
    return s


BODY_STREAMS: dict = {}  # (device, nesting depth) -> the stream of those bodies


def _cond_capture(pred, true_fn, false_fn, operands, at):
    """`cond` while a graph is captured: two conditional nodes."""
    graph = _LOCAL.conditional
    pred = pred.reshape(()).to(torch.bool)
    for first, fn in ((True, true_fn), (False, false_fn)):
        graph.begin_if(pred, negate=not first)  # its kernel runs outside the body
        before = [_copy(getattr(o, a)) for o, a in _COUNTERS]
        try:
            out = fn(*operands)
            if first:
                leaves = []
                struct = _flatten(out, leaves)
                outs = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
            else:
                (dst, _), (src, _) = _branch_leaves(_unflatten(struct, iter(outs)), out, at)
                for d, x in zip(dst, src):
                    if isinstance(d, torch.Tensor):
                        d.copy_(x)
            after = [getattr(o, a) for o, a in _COUNTERS]
            launches = tuple(y - x for x, y in zip(before, after))
            if any(launches):
                if graph.counts is None or len(graph.bodies) >= len(graph.counts):
                    raise RuntimeError(f"{_where(at)}: more conditional bodies captured than "
                                       "the warm-up ran")
                graph.counts[len(graph.bodies)].add_(1)
                graph.bodies.append(launches)
        finally:
            graph.end_if()
            for (o, a), v in zip(_COUNTERS, before):
                setattr(o, a, v)
    STATS["conds"] += 1
    return _unflatten(struct, iter(outs))


# -- graphs --------------------------------------------------------------------

class _Graph:
    """One captured call: its graph, static inputs and outputs, the device
    tables it holds, the launches it makes (outside its conditional
    bodies; `bodies`: the launches of each body that launches a counted
    kernel, `counts`: on the card, the replays that ran each since the last
    fold) and its memory."""

    def __init__(self, site, graph, inputs, out_struct, outputs, held, pinned, launches,
                 nbytes, capture_ms, bodies=(), counts=None):
        self.site = site
        self.capture_ms = capture_ms
        self.graph = graph
        self.inputs = inputs
        self.out_struct = out_struct
        self.outputs = outputs
        self.held = held  # the table and sequence tensors the capture read
        self.pinned = pinned
        self.launches = launches
        self.bodies, self.counts = bodies, counts
        self.nbytes = nbytes

    def __call__(self, traced):
        for s, x in zip(self.inputs, traced):
            _fill(s, x)
        self.graph.replay()
        _replayed_launches(self.launches)
        STATS["replays"] += 1
        return _unflatten(self.out_struct, iter([_fresh(t) for t in self.outputs]))

    def release(self):
        _fold([self])
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
    _LOCAL.conds = 0
    with _nested(), tracing(), torch.cuda.stream(side):
        _captured_launches(lambda: call_with(inputs))
    counts = None
    if _LOCAL.conds:  # the binding, and room for a replay count per body
        _cond_lib()
        counts = torch.zeros(2 * _LOCAL.conds, dtype=torch.int64, device=device)
    torch.cuda.synchronize(device)
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()

    conditional = _Conditional(side, device, _pool(device), "thread_local", counts)

    def capture():
        _LOCAL.conditional = conditional
        with _nested(), _device.recording() as used, torch.cuda.stream(side):
            graph.capture_begin(pool=_pool(device), capture_error_mode="thread_local")
            try:
                out = call_with(inputs)
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            finally:
                _LOCAL.conditional = None
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
               tuple(t for _, t in read.values()), pinned, launches, nbytes, ms,
               tuple(conditional.bodies), counts)
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

    def __init__(self, fn, static_argnums, static_argnames, bucket):
        self.fn = fn
        self.name = f"{fn.__module__}.{fn.__qualname__}"
        self.sig = inspect.signature(fn)
        names = list(self.sig.parameters)
        self.static = frozenset([names[i] for i in static_argnums] + list(static_argnames))
        unknown = self.static - set(names)
        if unknown:
            raise TypeError(f"{self.name} has no arguments {sorted(unknown)}")
        self.bucket = bucket

    def bind(self, args, kwargs, graphed=False) -> inspect.BoundArguments:
        """The call's arguments; `graphed`: as its graph takes them (after
        `bucket`)."""
        ba = self.sig.bind(*args, **kwargs)
        ba.apply_defaults()
        if graphed and self.bucket is not None:
            self.bucket(ba.arguments, self.device(ba))
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

    def device(self, ba, leaves=None) -> torch.device:
        """The device of the call: its first tensor argument's (`leaves`:
        the leaves of `split`), else its ``device=`` argument's (None: the
        CUDA device)."""
        if leaves is None:
            leaves = self.split(ba)[1]
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
        if device.type != "cuda" or _inside():
            return self.fn(*args, **kwargs)
        if self.bucket is not None:
            self.bucket(ba.arguments, device)
            static, leaves, struct = self.split(ba)
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


def _decorate(fn, static_argnums, static_argnames, bucket, kind):
    if isinstance(static_argnums, int):
        static_argnums = (static_argnums,)
    if isinstance(static_argnames, str):
        static_argnames = (static_argnames,)
    site = _Site(fn, tuple(static_argnums), tuple(static_argnames), bucket)

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


def lazy_jit(fn=None, *, static_argnums=(), static_argnames=(), bucket=None):
    """Decorator: an entry point that replays one CUDA graph per key (see
    the module docstring).  ``bucket(arguments, device)``, where given,
    rewrites a graphed call's bound arguments (a dict, in place) before
    they are keyed: it may put a coarser static argument in place of one,
    moving what that drops into a traced argument."""
    if fn is None:
        return lambda f: lazy_jit(f, static_argnums=static_argnums,
                                  static_argnames=static_argnames, bucket=bucket)
    return _decorate(fn, static_argnums, static_argnames, bucket, "entry")


def stage(fn=None, *, static_argnums=(), static_argnames=()):
    """Decorator: a function that the package calls outside its entry
    points as well (the DL-SCH decoder under the UL and sidelink paths),
    graphed as `lazy_jit` graphs an entry point."""
    if fn is None:
        return lambda f: stage(f, static_argnums=static_argnums, static_argnames=static_argnames)
    return _decorate(fn, static_argnums, static_argnames, None, "stage")


def graph_key(fn, *args, **kwargs):
    """The key a call of the wrapped `fn` would replay under."""
    site = fn.jit_site
    return site.key(site.bind(args, kwargs, graphed=True))


def traced_args(fn, *args, **kwargs):
    """(args, kwargs) of a call of the wrapped `fn` as its graph is
    captured: every traced argument a tensor on the call's device (for
    tests on the CPU, through ``fn.__wrapped__``)."""
    site = fn.jit_site
    b = site.traced(site.bind(args, kwargs, graphed=True))
    return b.args, b.kwargs
