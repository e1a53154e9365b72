"""The port's `utils/jit.py` (one CUDA graph per call on the card) on the CPU.

(a) the port wraps the counterpart of every `lazy_jit` site of the JAX
package (read from its sources as text), with the same static arguments;
(b) each wrapped function, run as its graph would run it (its traced
arguments as tensors, every `jit.cond` under `jit.tracing`: both branches,
merged), reads nothing back to the host, makes no tensor of host data once
its tables are built, meets no operation whose output shape depends on the
data, changes none of its arguments and equals the eager call: what a CUDA
graph cannot hold; `dlsch_decode` so on each mix of the cascade's branches;
(c) the graph keys; `jit.cond` eagerly, traced and as a capture builds its
conditional bodies (with a stand-in for the card's nodes); (d)
`_device.sequence` keeps the tensors a graph pins; the launch counters'
bookkeeping and the bodies' fold; the graph cache's eviction;
`utils/boundary.py` against the JAX package's.  6 PRB LTE cells and a 24
PRB NR carrier.
"""

import ast
import contextlib
import dataclasses
import importlib
import traceback
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import srslte_tpu.utils.boundary as j_boundary
import srslte_tpu_torch._device as t_device
import srslte_tpu_torch.phy.phch.dlsch as t_dlsch
import srslte_tpu_torch.utils.boundary as t_boundary
from srslte_tpu_torch.phy.common.params import CP, Cell, OfdmParams
from srslte_tpu_torch.phy.nbiot.npbch import Npbch
from srslte_tpu_torch.phy.nr.params import NrCarrier
from srslte_tpu_torch.phy.nr.pdsch_nr import NrPdsch
from srslte_tpu_torch.phy.phch.pbch import Pbch
from srslte_tpu_torch.phy.phch.pdcch import Location, Pdcch, rnti_mask_t
from srslte_tpu_torch.phy.phch.pdsch import Pdsch, PdschSm, PdschSm4
from srslte_tpu_torch.phy.phch.pmch import Pmch
from srslte_tpu_torch.phy.phch.ra import DlGrant
from srslte_tpu_torch.phy.sync.sync import sync_find
from srslte_tpu_torch.phy.ue import ue_sync
from srslte_tpu_torch.phy.ue.intra_measure import IntraMeasure
from srslte_tpu_torch.phy.ue.ue_cell_search import cell_search
from srslte_tpu_torch.phy.ue.ue_dl import UeDl
from srslte_tpu_torch.phy.ue.ue_mib import UeMib
from srslte_tpu_torch.utils import jit

import test_torch_fec as fec  # its DL-SCH cascade pool and mixes

torch.set_num_threads(1)  # several test workers share the machine's cores
ROOT = Path(__file__).resolve().parent.parent
CELL = Cell(n_prb=6, id=7)
SF_LEN = CELL.ofdm.sf_len


# -- (a) the sites ---------------------------------------------------------------

def literal(node):
    """A decorator argument's value, or its source where it is no literal
    (a function)."""
    try:
        return ast.literal_eval(node)
    except ValueError:
        return ast.unparse(node)


def decorated_sites(package: str, decorator: str = "lazy_jit") -> dict:
    """{(module path in the package, qualified name): the decorator's
    keyword arguments} of every function decorated by `decorator`, read
    from the package's sources."""
    sites = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        rel = path.relative_to(ROOT / package).as_posix()

        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, prefix + child.name + ".")
                elif isinstance(child, ast.FunctionDef):
                    for d in child.decorator_list:
                        call = d if isinstance(d, ast.Call) else None
                        name = call.func if call else d
                        if isinstance(name, ast.Name) and name.id == decorator:
                            sites[(rel, prefix + child.name)] = {
                                k.arg: literal(k.value) for k in call.keywords
                            } if call else {}

        visit(ast.parse(path.read_text()), "")
    return sites


# the port merged the JAX package's _decode_candidates_traced into
# _decode_mixed_traced (every candidate set is a tuple of per-L tuples)
MERGED = {("phy/phch/pdcch.py", "Pdcch._decode_candidates_traced"):
          ("phy/phch/pdcch.py", "Pdcch._decode_mixed_traced")}


def port_object(rel: str, qual: str):
    mod = importlib.import_module("srslte_tpu_torch." + rel[:-3].replace("/", "."))
    obj = mod
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def test_wrapped_sites_are_the_jax_packages():
    """Every `lazy_jit` site of the JAX package has a wrapped counterpart
    with the same static arguments (a subclass may inherit it), and the
    port wraps no other entry point."""
    jax_sites = decorated_sites("srslte_tpu")
    jax_sites.pop(("utils/jit.py", "lazy_jit"), None)
    assert len(jax_sites) == 21
    want = {MERGED.get(k, k): v for k, v in jax_sites.items()}
    for (rel, qual), static in jax_sites.items():
        obj = port_object(*MERGED.get((rel, qual), (rel, qual)))
        assert getattr(obj, "jit_kind", None) == "entry", f"{rel} {qual} is not wrapped"
        sig = list(obj.jit_site.sig.parameters)
        names = {sig[i] for i in static.get("static_argnums", ())}
        names |= set(static.get("static_argnames", ()))
        assert obj.jit_site.static == names, (rel, qual)
    port_sites = decorated_sites("srslte_tpu_torch")
    assert set(port_sites) <= set(want)
    for k, v in port_sites.items():
        # `bucket` (the PDSCH decoders' RNTI as an input) keys no static argument
        assert {a: v[a] for a in v if a != "bucket"} == want[k], k
    # every site is one graph per call: none is split into stages
    assert not any("segmented" in v for v in port_sites.values())
    assert all(not hasattr(port_object(*MERGED.get(k, k)).jit_site, "segmented")
               for k in jax_sites)
    assert {k for k, v in port_sites.items() if "bucket" in v} == {
        ("phy/phch/pdsch.py", "Pdsch.decode"), ("phy/phch/pdsch.py", "PdschSm.decode2")}


# -- (b) no host read, no upload, no data-dependent shape ---------------------------

_READS = {"__bool__", "__int__", "__float__", "__index__", "__complex__", "item", "tolist",
          "numpy", "cpu", "__array__"}
_SHAPES = {"nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
           "unique_consecutive", "masked_scatter"}


# a kernel's plain version runs on the CPU only: the card launches the kernel
PLAIN = {"siso_windowed_plain", "viterbi_decode_plain"}


def where() -> str | None:
    """file:line of the innermost frame of the port on the stack; None
    inside a kernel's plain version."""
    stack = traceback.extract_stack()
    if any(f.name in PLAIN for f in stack):
        return None
    for f in reversed(stack):
        if "srslte_tpu_torch" in f.filename and "utils/jit.py" not in f.filename:
            return f"{Path(f.filename).relative_to(ROOT)}:{f.lineno}"
    return "?"


def found(kinds: dict, kind: str, what: str):
    at = where()
    if at is not None:
        kinds[kind].append(f"{what} at {at}")


class GraphHazards(TorchFunctionMode):
    """Records what a CUDA graph cannot hold: host reads (`found["read"]`),
    tensors made of host data ("upload") and data-dependent shapes
    ("shape")."""

    def __init__(self):
        super().__init__()
        self.found = {"read": [], "upload": [], "shape": []}
        self.dispatch = _Dispatch(self.found)

    def __enter__(self):
        self.dispatch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        return self.dispatch.__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        if name in _READS:
            found(self.found, "read", name)
        return func(*args, **(kwargs or {}))


class _Dispatch(TorchDispatchMode):
    def __init__(self, found):
        super().__init__()
        self.found = found

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name == "_local_scalar_dense":
            found(self.found, "read", name)
        elif name == "lift_fresh":
            found(self.found, "upload", name)
        elif name in _SHAPES or name == "repeat_interleave" and func.name().endswith(".Tensor"):
            found(self.found, "shape", name)
        elif name in ("index", "index_put", "index_put_"):
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1]):
                found(self.found, "shape", f"{name} with a boolean mask")
        return func(*args, **(kwargs or {}))


def rng_c(rng, *shape):
    return torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                            .astype(np.complex64))


def lte_grid(rng, cell, *lead):
    o = cell.ofdm
    return rng_c(rng, *lead, o.nsymb_sf, o.nof_re)


def pdsch_case(rng):
    p = Pdsch(CELL, DlGrant.full(6, 9), 4, cfi=2, rnti=0x46)
    return Pdsch.decode, (p, lte_grid(rng, CELL, 2), lte_grid(rng, CELL, 2, 1), 0.3), {}


def sm_case(rng, cls, ports, rnti=0x46):
    cell = Cell(n_prb=6, id=3, nof_ports=ports)
    p = cls(cell, DlGrant.full(6, 10), 4, cfi=2, rnti=rnti, pmi=0)
    return (p, lte_grid(rng, cell, 2, ports), rng_c(rng, 2, ports, ports, cell.ofdm.nsymb_sf,
                                                     cell.ofdm.nof_re), 0.1)


def sm_encode(rng, cls, ports):
    cell = Cell(n_prb=6, id=3, nof_ports=ports)
    p = cls(cell, DlGrant.full(6, 10), 4, cfi=2, rnti=0x46, pmi=1)
    bits = [rng.integers(0, 2, (2, p.cfg_q(q).tbs)).astype(np.uint8) for q in range(2)]
    return cls.encode2, (p, *bits, torch.zeros((2, ports, cell.ofdm.nsymb_sf, cell.ofdm.nof_re),
                                               dtype=torch.complex64)), {}


def pmch_case(rng):
    cell = Cell(n_prb=6, id=5, cp=CP.EXT)
    return Pmch.decode, (Pmch(cell, area_id=1, sf_idx=3, mcs=8), lte_grid(rng, cell, 2)), {}


def nr_case(rng, method):
    p = NrPdsch(NrCarrier(n_prb=24, n_id=17), mcs_qm=4, rate=0.4, rnti=0x4601, slot=3)
    if method == "encode":
        return NrPdsch.encode, (p, rng.integers(0, 2, (2, p.tbs)).astype(np.uint8), "cpu"), {}
    return getattr(NrPdsch, method), (p, rng_c(rng, 2, 14, p.carrier.nof_re)), {}


def dlsch_case(mix):
    """`dlsch_decode` on one mix of test_torch_fec.py's cascade pool: 64 TBs
    of one K 512 code block, whose branches the mix picks."""
    bits, llr, need = fec.cascade_pool()
    return t_dlsch.dlsch_decode, (torch.from_numpy(llr[fec.cascade_rows(mix, need)]),
                                  t_dlsch.DlschConfig(**fec.CASCADE_CFG)), {}


def stream(rng, n):
    return rng_c(rng, n)


CASES = {
    "UeDl.fft_estimate": lambda r: (UeDl.fft_estimate, (UeDl(CELL), rng_c(r, 2, SF_LEN), 4), {}),
    "Pdcch.decode_candidates": lambda r: (Pdcch.decode_candidates, (
        Pdcch(CELL, 2, 4), lte_grid(r, CELL, 2), lte_grid(r, CELL, 2, 1),
        (Location(0, 2), Location(2, 2)), 27, 0x46), {}),
    "Pdcch._decode_mixed_traced": lambda r: (Pdcch._decode_mixed_traced, (
        Pdcch(CELL, 2, 4), lte_grid(r, CELL, 2), lte_grid(r, CELL, 2, 1),
        ((Location(0, 2), Location(2, 2)), (Location(0, 4),)), 27, rnti_mask_t(0x46, "cpu")),
        {}),
    "Pdsch.decode": pdsch_case,
    "PdschSm.encode2": lambda r: sm_encode(r, PdschSm, 2),
    "PdschSm.decode2": lambda r: (PdschSm.decode2, sm_case(r, PdschSm, 2), {}),
    "PdschSm4.encode2": lambda r: sm_encode(r, PdschSm4, 4),
    "PdschSm4.decode2": lambda r: (PdschSm4.decode2, sm_case(r, PdschSm4, 4), {}),
    "Pmch.decode": pmch_case,
    "NrPdsch.encode": lambda r: nr_case(r, "encode"),
    "NrPdsch.demod_llr": lambda r: nr_case(r, "demod_llr"),
    "NrPdsch.decode": lambda r: nr_case(r, "decode"),
    "Pbch._decode_dev": lambda r: (Pbch._decode_dev, (
        Pbch(Cell(n_prb=6, id=7, nof_ports=2)), lte_grid(r, CELL), lte_grid(r, CELL, 2)), {}),
    "UeMib._front": lambda r: (UeMib._front, (UeMib(7), rng_c(r, SF_LEN)), {}),
    "Npbch._decode_dev": lambda r: (Npbch._decode_dev, (
        Npbch(257, 2), rng_c(r, 14, 12), rng_c(r, 2, 14, 12)), {}),
    "sync_find": lambda r: (sync_find, (stream(r, 2 * 9600), OfdmParams(6)), {}),
    "_slice_prefix": lambda r: (ue_sync._slice_prefix, (stream(r, 20000), 9600), {}),
    "_track_dev": lambda r: (ue_sync._track_dev, (
        stream(r, 12 * SF_LEN), 1234, 0.013, OfdmParams(6), 5, (1,)), {}),
    "_track_dev negative start": lambda r: (ue_sync._track_dev, (
        stream(r, 12 * SF_LEN), -700, -0.2, OfdmParams(6), 5, (0,)), {}),
    "cell_search": lambda r: (cell_search, (stream(r, 4 * 9600), OfdmParams(6)), {}),
    "IntraMeasure.measure": lambda r: (IntraMeasure.measure, (
        IntraMeasure(6, (7, 111)), rng_c(r, 2, SF_LEN), 2), {}),
    **{f"dlsch_decode {mix}": (lambda r, mix=mix: dlsch_case(mix)) for mix in fec.CASCADE_CASES},
}


def tree_clone(x):
    leaves = []
    struct = jit._flatten(x, leaves)
    return jit._unflatten(struct, iter([v.clone() if isinstance(v, torch.Tensor) else v
                                        for v in leaves]))


def assert_same(a, b):
    la, lb = [], []
    sa, sb = jit._flatten(a, la), jit._flatten(b, lb)
    assert sa == sb
    for x, y in zip(la, lb):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            assert x == y


@pytest.mark.parametrize("name", list(CASES))
def test_no_graph_hazards(name):
    """The call as its graph is captured (traced arguments as tensors, the
    `bucket` rewrite, both branches of every `jit.cond`) meets no host read,
    no upload once its tables are built and no shape that depends on the
    data, changes none of its arguments, and equals the plain eager call."""
    fn, args, kwargs = CASES[name](np.random.default_rng(len(name)))
    assert fn.jit_kind in ("entry", "stage")
    targs, tkwargs = jit.traced_args(fn, *args, **kwargs)
    before = [tree_clone(x) for x in (args, kwargs, targs, tkwargs)]
    with jit.tracing():
        fn.__wrapped__(*targs, **tkwargs)  # builds the tables both branches read
        with GraphHazards() as mode:
            got = fn.__wrapped__(*targs, **tkwargs)
    assert mode.found == {"read": [], "upload": [], "shape": []}
    eager = fn.__wrapped__(*args, **kwargs)
    assert_same(got, eager)
    for x, y in zip((args, kwargs, targs, tkwargs), before):
        assert_same(x, y)


def host_reads(run):
    run()
    with GraphHazards() as mode:
        out = run()
    return out, mode.found


def bool_reads(found) -> int:
    """The host reads of `found` that are a tensor's truth value."""
    kinds = [r.split()[0] for r in found["read"]]
    assert set(kinds) <= {"__bool__", "_local_scalar_dense"}, kinds
    return kinds.count("__bool__")


# the conds each mix's eager cascade evaluates (one host read each): phase
# 1's; phase 2's nfail == 0; nfail <= cap; phase 3's nfail3 == 0; nfail3 <= cap2
CASCADE_READS = {"all_pass_after_early": 1, "all_pass_after_second": 2,
                 "compaction_then_clean": 4, "second_compaction": 5,
                 "second_capacity_exceeded": 5, "full_batch_fallback": 3}


@pytest.mark.parametrize("traced", [False, True])
def test_cascade_host_reads(traced):
    """`dlsch_decode` eagerly reads the host once per cond it takes (one
    read on a batch whose blocks all pass phase 1); as its graph runs it
    (`jit.tracing`) never.  Each mix's flags and bits are the same both
    ways."""
    cfg = t_dlsch.DlschConfig(**fec.CASCADE_CFG)
    bits, llr, need = fec.cascade_pool()
    for mix, reads in CASCADE_READS.items():
        x = torch.from_numpy(llr[fec.cascade_rows(mix, need)])
        with (jit.tracing() if traced else contextlib.nullcontext()):
            (got, ok), found = host_reads(lambda: t_dlsch.dlsch_decode(x, cfg))
        assert bool_reads(found) == (0 if traced else reads), mix
        assert not found["upload"] and not found["shape"]
        np.testing.assert_array_equal(ok.numpy(), need[fec.cascade_rows(mix, need)] <= 5)
        sent = bits[fec.cascade_rows(mix, need)]
        assert (got.numpy()[ok.numpy()] == sent[ok.numpy()]).all()


# -- jit.cond ----------------------------------------------------------------------

class Branch:
    """A branch that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a):
        self.calls += 1
        return self.fn(*a)


@pytest.mark.parametrize("value", [True, False])
def test_cond_eager_calls_one_branch(value):
    """Eagerly `cond` reads its predicate once and calls the branch it
    picks, with the operands."""
    x = torch.arange(6.0)
    t, f = Branch(lambda a, b: (a * 2, {"n": b + 1})), Branch(lambda a, b: (a - 1, {"n": b}))
    pred, three = torch.tensor(value), torch.tensor(3)
    with GraphHazards() as mode:
        out = jit.cond(pred, t, f, x, three)
    assert bool_reads(mode.found) == 1
    assert (t.calls, f.calls) == ((1, 0) if value else (0, 1))
    assert_same(out, (x * 2, {"n": torch.tensor(4)}) if value else (x - 1, {"n": torch.tensor(3)}))


@pytest.mark.parametrize("value", [True, False])
def test_cond_traced_runs_both_and_merges(value):
    """Under `tracing` both branches run and each output leaf is the picked
    branch's, merged by the predicate with no host read."""
    x = torch.arange(6.0)
    t, f = Branch(lambda: (x * 2, x.to(torch.int64))), Branch(lambda: (x - 1, -x.to(torch.int64)))
    pred = torch.tensor(value)
    with jit.tracing(), GraphHazards() as mode:
        out = jit.cond(pred, t, f)
    assert mode.found == {"read": [], "upload": [], "shape": []}
    assert (t.calls, f.calls) == (1, 1)
    assert_same(out, (x * 2, x.to(torch.int64)) if value else (x - 1, -x.to(torch.int64)))


def nested(x):
    """Three branches by two nested conds on values the function computes."""
    s = x.sum()
    return jit.cond(s > 0, lambda: jit.cond(s > 10, lambda: x * 3, lambda: x * 2),
                    lambda: (x - 1).abs())


@pytest.mark.parametrize("value", [5.0, 1.0, -1.0])
def test_cond_nested(value):
    """Nested conds give the eager result traced, on every branch."""
    x = torch.full((4,), value)
    want = x * 3 if value > 2.5 else x * 2 if value > 0 else (x - 1).abs()
    assert_same(nested(x), want)
    with jit.tracing():
        assert_same(nested(x), want)


@pytest.mark.parametrize("false_out", [
    lambda x: x[:2], lambda x: x.to(torch.float64), lambda x: (x,), lambda x: [x], lambda x: None])
def test_cond_mismatch_raises(false_out):
    """Branches whose outputs differ in structure, shape or dtype raise in
    the traced mode (and in a capture), naming the cond's site."""
    x = torch.arange(4.0)
    with jit.tracing(), pytest.raises(ValueError, match=r"jit\.cond at .*test_torch_jit\.py"):
        jit.cond(torch.tensor(True), lambda: x, lambda: false_out(x))


class StandInNodes:
    """`_Conditional`'s interface without a card: records the bodies begun
    and ended (both bodies then run, one after the other, on the CPU)."""

    def __init__(self, counts):
        self.counts, self.bodies, self.log, self.depth = counts, [], [], 0

    def begin_if(self, pred, negate):
        jit._Conditional.launches += 1
        self.depth += 1
        self.log.append(("begin", self.depth, bool(pred) ^ negate))

    def end_if(self):
        self.log.append(("end", self.depth))
        self.depth -= 1


def test_cond_capture_bodies(monkeypatch):
    """In a capture each branch is a body: nested bodies begin and end in
    order, the second body writes its outputs into the first's (fresh
    tensors, so an operand is never written), each body that launches a
    counted kernel gets a replay count, and the graph's own launches leave
    out those of its bodies (the handle kernels of the nested conds count
    where they run)."""
    class Kernel:
        launches = 0

    monkeypatch.setattr(jit, "_COUNTERS", [])
    jit.count_launches(jit._Conditional, "launches")
    jit.count_launches(Kernel, "launches")

    def kernel(x):
        Kernel.launches += 1
        return x + 1

    x = torch.zeros(3)
    nodes = StandInNodes(torch.zeros(8, dtype=torch.int64))

    def run():
        jit._LOCAL.conditional = nodes
        try:
            h1 = kernel(x)
            return jit.cond(h1.sum() > 10, lambda: h1, lambda: jit.cond(
                h1.sum() > 1, lambda: kernel(h1), lambda: kernel(kernel(h1))))
        finally:
            jit._LOCAL.conditional = None

    out, launches = jit._captured_launches(run)
    assert [e[0] for e in nodes.log] == ["begin", "end", "begin", "begin", "end", "begin",
                                         "end", "end"]
    assert [e[1] for e in nodes.log if e[0] == "begin"] == [1, 1, 2, 2]
    assert launches == (2, 1)  # the outer cond's two handle kernels, h1
    # the inner bodies (1 and 2 kernels), then the outer false body (the
    # inner cond's two handle kernels)
    assert nodes.bodies == [(0, 1), (0, 2), (2, 0)]
    assert nodes.counts.tolist() == [1, 1, 1, 0, 0, 0, 0, 0]  # each body's add, once
    assert (jit._Conditional.launches, Kernel.launches) == (0, 0)
    assert_same(out, torch.full((3,), 3.0)) and (x == 0).all()


def test_fold_launches(monkeypatch):
    """The fold adds each body's launches as many times as its count says,
    for every graph (each with its own room for counts), and zeroes the
    counts; a released graph is folded first."""
    class Kernel:
        launches = 0
        shapes = Counter()

    monkeypatch.setattr(jit, "_COUNTERS", [])
    jit.count_launches(Kernel, "launches", "shapes")
    monkeypatch.setattr(jit, "_GRAPHS", type(jit._GRAPHS)())

    class StandIn:
        reset_calls = 0

        def reset(self):
            StandIn.reset_calls += 1

    def graph(bodies, counts):
        return jit._Graph("site", StandIn(), [], None, [], (), (), (0, Counter()), 0, 0.0,
                          tuple(bodies), torch.tensor(counts, dtype=torch.int64))

    a = graph([(1, Counter({"B=1": 1})), (2, Counter({"B=2": 2}))], [3, 0, 0, 0])
    b = graph([(5, Counter({"B=5": 5}))], [2, 0, 0, 0, 0, 0])
    jit._GRAPHS.update(a=a, b=b)
    jit.fold_launches()
    assert Kernel.launches == 3 * 1 + 2 * 5
    assert Kernel.shapes == Counter({"B=1": 3, "B=5": 10})
    assert a.counts.tolist() == [0] * 4 and b.counts.tolist() == [0] * 6
    b.counts[0] = 1
    a.counts[1] = 1
    b.release()
    assert Kernel.launches == 13 + 5 and StandIn.reset_calls == 1
    jit.fold_launches()
    assert Kernel.launches == 18 + 2  # a's second body; b's count went in its release


def test_graph_cache_evicts_least_recently_used(monkeypatch):
    """Over `GRAPH_BYTES` the cache drops the least recently used graphs
    (never the one just captured), keeps the byte total under the budget,
    releases each dropped graph (reset, its sequences unpinned) and keeps
    the pins of the graphs it holds."""
    monkeypatch.setattr(jit, "_GRAPHS", type(jit._GRAPHS)())
    monkeypatch.setattr(jit, "GRAPH_BYTES", 10)
    monkeypatch.setattr(t_device, "_PINS", {})
    released = []

    class StandIn:
        def __init__(self, name):
            self.name = name

        def reset(self):
            released.append(self.name)

    def insert(name, nbytes):
        pinned = (("seq", name),)
        t_device.pin(pinned)
        jit._insert(name, jit._Graph(name, StandIn(name), [], None, [], (), pinned, (), nbytes,
                                     0.0))

    for name in "abc":
        insert(name, 4)
    assert jit.keys() == ["b", "c"] and released == ["a"]
    jit._GRAPHS.move_to_end("b")  # a replay of b
    insert("d", 4)
    assert jit.keys() == ["b", "d"] and released == ["a", "c"]
    assert sum(g.nbytes for g in jit._GRAPHS.values()) <= jit.GRAPH_BYTES
    assert set(t_device._PINS) == {("seq", "b"), ("seq", "d")}
    insert("e", 40)  # alone over the budget: it stays, the others go
    assert jit.keys() == ["e"] and released == ["a", "c", "b", "d"]
    assert set(t_device._PINS) == {("seq", "e")}


# -- (c) keys ---------------------------------------------------------------------

def test_keys():
    """Equal processors share a key, a static argument or a shape makes
    another, and a traced argument never enters it."""
    rng = np.random.default_rng(3)
    x = rng_c(rng, 2, SF_LEN)
    k = jit.graph_key(UeDl.fft_estimate, UeDl(CELL), x, 4)
    assert k == jit.graph_key(UeDl.fft_estimate, UeDl(Cell(n_prb=6, id=7)), x.clone(), 4)
    assert k != jit.graph_key(UeDl.fft_estimate, UeDl(CELL), x, 5)
    assert k != jit.graph_key(UeDl.fft_estimate, UeDl(CELL, "wiener"), x, 4)
    assert k != jit.graph_key(UeDl.fft_estimate, UeDl(CELL), x[:1], 4)
    assert k != jit.graph_key(UeDl.fft_estimate, UeDl(CELL), x.to(torch.complex128), 4)
    p, grid, ce, _ = sm_case(rng, PdschSm, 2)
    keys = {jit.graph_key(PdschSm.decode2, PdschSm(**{
        f: getattr(p, f) for f in p.__dataclass_fields__}), grid, ce, nv) for nv in (0.1, 0.7)}
    keys.add(jit.graph_key(PdschSm.decode2, p, grid, ce, 0.3, n_iter=5))
    # the RNTI seeds the descrambling, a traced input (`bucket`): every UE
    # shares the key
    keys.add(jit.graph_key(PdschSm.decode2, *sm_case(rng, PdschSm, 2, rnti=0x1234)))
    assert len(keys) == 1
    assert keys != {jit.graph_key(PdschSm.decode2, p, grid, ce, 0.3, n_iter=4)}
    pd = pdsch_case(rng)[1]
    assert jit.graph_key(Pdsch.decode, *pd) == jit.graph_key(
        Pdsch.decode, dataclasses.replace(pd[0], rnti=0x1234), *pd[1:])
    s = stream(rng, 12 * SF_LEN)
    track = {jit.graph_key(ue_sync._track_dev, s, pos, cfo, OfdmParams(6), 5, (1,))
             for pos, cfo in ((0, 0.0), (1234, 0.3), (-50, -0.1))}
    assert len(track) == 1
    mixed = Pdcch(CELL, 2, 4), lte_grid(rng, CELL, 2), lte_grid(rng, CELL, 2, 1), ((Location(0, 4),),), 27
    assert len({jit.graph_key(Pdcch._decode_mixed_traced, *mixed, rnti_mask_t(r, "cpu"))
                for r in (0x46, 0xFFFF, 0x1234)}) == 1


def test_cpu_calls_the_function():
    """On the CPU a wrapped function runs as itself: no graph is made."""
    before = jit.graphs()["count"]
    x = rng_c(np.random.default_rng(0), 2, SF_LEN)
    grid, ce, info = UeDl.fft_estimate(UeDl(CELL), x, 4)
    assert_same((grid, ce, info), UeDl.fft_estimate.__wrapped__(UeDl(CELL), x, 4))
    assert jit.graphs()["count"] == before
    assert UeDl.fft_estimate.__wrapped__.__name__ == "fft_estimate"


# -- (d) pinned sequences; launch counters -------------------------------------------

def test_sequence_keeps_pinned(monkeypatch):
    """Over its budget `sequence` drops the least recently used tensor that
    no graph pins."""
    monkeypatch.setattr(t_device, "_SEQUENCES", type(t_device._SEQUENCES)())
    monkeypatch.setattr(t_device, "SEQUENCE_BYTES", 3 * 4096)
    build = lambda: np.zeros(1024, np.float32)  # 4096 bytes
    a = t_device.sequence("a", "cpu", build)
    key_a = ("a", "cpu", None)
    t_device.pin([key_a])
    try:
        for name in "bcde":
            t_device.sequence(name, "cpu", build)
        assert set(k[0] for k in t_device._SEQUENCES) == {"a", "d", "e"}
        assert t_device.sequence("a", "cpu", build) is a
    finally:
        t_device.unpin([key_a])
    for name in "fgh":  # "a", read last, is dropped last
        t_device.sequence(name, "cpu", build)
    assert set(k[0] for k in t_device._SEQUENCES) == {"f", "g", "h"}
    with t_device.recording() as used:
        t_device.sequence("h", "cpu", build)
        t_device.table(("jit test", 1), "cpu", build)
    assert [(kind, k[0]) for kind, k, _ in used] == [("sequence", "h"),
                                                    ("table", ("jit test", 1))]


def test_launch_counters(monkeypatch):
    """A capture's launches are taken off the counters (counts and counts
    by shape) and added back at each replay."""
    class Kernel:
        launches = 5
        launches_bf16 = 0
        shapes = Counter({"B=1": 5})

    monkeypatch.setattr(jit, "_COUNTERS", [])
    jit.count_launches(Kernel, "launches", "launches_bf16", "shapes")
    jit.count_launches(Kernel, "launches")

    def captured():
        Kernel.launches += 3
        Kernel.launches_bf16 += 1
        Kernel.shapes["B=2"] += 3
        return "out"

    out, launches = jit._captured_launches(captured)
    assert out == "out" and launches == (3, 1, Counter({"B=2": 3}))
    assert (Kernel.launches, Kernel.launches_bf16, Kernel.shapes) == (5, 0, Counter({"B=1": 5}))
    for _ in range(2):
        jit._replayed_launches(launches)
    assert (Kernel.launches, Kernel.launches_bf16) == (11, 2)
    assert Kernel.shapes == Counter({"B=1": 5, "B=2": 6})
    with pytest.raises(ValueError):
        jit._captured_launches(lambda: (setattr(Kernel, "launches", 99), int("x")))
    assert Kernel.launches == 11


# -- utils/boundary.py -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 1, 4)])
def test_boundary(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex128)
    t = t_boundary.to_device_complex(x, device="cpu")
    j = j_boundary.to_device_complex(x)
    assert t.dtype == torch.complex64 and t.shape == shape
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    back = t_boundary.from_device_complex(t)
    assert back.dtype == np.complex64
    np.testing.assert_array_equal(back, j_boundary.from_device_complex(jnp.asarray(j)))
