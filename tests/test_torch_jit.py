"""The port's `utils/jit.py` (one CUDA graph per call on the card) on the CPU.

(a) the port wraps the counterpart of every `lazy_jit` site of the JAX
package (read from its sources as text), with the same static arguments;
(b) each wrapped function, and each stage of the segmented ones, run eagerly
with its traced arguments as the graph takes them (tensors), reads nothing
back to the host, makes no tensor of host data once its tables are built,
and meets no operation whose output shape depends on the data: what a CUDA
graph cannot hold; (c) the graph keys; (d) `_device.sequence` keeps the
tensors a graph pins; the launch counters' bookkeeping; `utils/boundary.py`
against the JAX package's.  6 PRB LTE cells and a 24 PRB NR carrier.
"""

import ast
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

torch.set_num_threads(1)  # several test workers share the machine's cores
ROOT = Path(__file__).resolve().parent.parent
CELL = Cell(n_prb=6, id=7)
SF_LEN = CELL.ofdm.sf_len


# -- (a) the sites ---------------------------------------------------------------

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
                                k.arg: ast.literal_eval(k.value) for k in call.keywords
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
        assert {a: v[a] for a in v if a != "segmented"} == want[k], k
    # the entry points whose device work is split by host reads
    segmented = {k for k, v in port_sites.items() if v.get("segmented")}
    assert segmented == {("phy/phch/pdsch.py", "Pdsch.decode"),
                         ("phy/phch/pdsch.py", "PdschSm.decode2"),
                         ("phy/phch/pmch.py", "Pmch.decode")}


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


def cascade_inputs():
    """A two-block DL-SCH bucket (K 3008, windowed) at a noise where phase
    1 leaves failures, and the states each stage takes."""
    cfg = t_dlsch.DlschConfig(tbs=6000, G=14400, Qm=2)
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (4, cfg.tbs)).astype(np.uint8)
    coded = t_dlsch.dlsch_encode(bits, cfg, device="cpu").numpy()
    llr = torch.from_numpy(((1 - 2.0 * coded) * -2.0 + 2.2 * rng.standard_normal(coded.shape))
                           .astype(np.float32))
    front = t_dlsch.cascade_front(llr, cfg, 5)
    hard, st = front.hard[0], front.state[0]
    hard2, st2, ok2, _ = t_dlsch._phase2.__wrapped__(hard, st, cfg, 0, 5, 1, 8)
    hard3, st3, ok3, idx, _ = t_dlsch._phase3.__wrapped__(hard2, st2, ok2, cfg, 0, 8)
    return dict(cfg=cfg, llr=llr, front=front, hard2=hard2, st2=st2, ok2=ok2, hard3=hard3,
                st3=st3, ok3=ok3, idx=idx)


def pdsch_case(rng):
    p = Pdsch(CELL, DlGrant.full(6, 9), 4, cfi=2, rnti=0x46)
    return p._decode_front, (p.bucket, lte_grid(rng, CELL, 2), lte_grid(rng, CELL, 2, 1), 0.3,
                             p.descrambling(0, p.cfg.G, "cpu")), {}


def sm_case(rng, cls, ports, rnti=0x46):
    cell = Cell(n_prb=6, id=3, nof_ports=ports)
    p = cls(cell, DlGrant.full(6, 10), 4, cfi=2, rnti=rnti, pmi=0)
    return (p.bucket, lte_grid(rng, cell, 2, ports), rng_c(rng, 2, ports, ports,
                                                           cell.ofdm.nsymb_sf, cell.ofdm.nof_re),
            0.1, p._scrs(None, "cpu"))


def sm_encode(rng, cls, ports):
    cell = Cell(n_prb=6, id=3, nof_ports=ports)
    p = cls(cell, DlGrant.full(6, 10), 4, cfi=2, rnti=0x46, pmi=1)
    bits = [rng.integers(0, 2, (2, p.cfg_q(q).tbs)).astype(np.uint8) for q in range(2)]
    return cls.encode2, (p, *bits, torch.zeros((2, ports, cell.ofdm.nsymb_sf, cell.ofdm.nof_re),
                                               dtype=torch.complex64)), {}


def pmch_case(rng):
    cell = Cell(n_prb=6, id=5, cp=CP.EXT)
    return Pmch._decode_front, (Pmch(cell, area_id=1, sf_idx=3, mcs=8),
                                lte_grid(rng, cell, 2)), {}


def nr_case(rng, method):
    p = NrPdsch(NrCarrier(n_prb=24, n_id=17), mcs_qm=4, rate=0.4, rnti=0x4601, slot=3)
    if method == "encode":
        return NrPdsch.encode, (p, rng.integers(0, 2, (2, p.tbs)).astype(np.uint8), "cpu"), {}
    return getattr(NrPdsch, method), (p, rng_c(rng, 2, 14, p.carrier.nof_re)), {}


def cascade_case(stage):
    c = cascade_inputs()
    cfg, front = c["cfg"], c["front"]
    return {
        "_front": (t_dlsch._front, (c["llr"], cfg, 5), {}),
        "_phase2": (t_dlsch._phase2, (front.hard[0], front.state[0], cfg, 0, 5, 1, 8), {}),
        "_more": (t_dlsch._more, (c["st2"], cfg, 0, 3), {}),
        "_phase3": (t_dlsch._phase3, (c["hard2"], c["st2"], c["ok2"], cfg, 0, 8), {}),
        "_phase3b": (t_dlsch._phase3b, (c["hard3"], c["st3"], c["ok3"], cfg, 0, 2), {}),
        "_merged": (t_dlsch._merged, (c["hard2"], c["ok2"], c["idx"], c["hard3"]), {}),
        "_tail": (t_dlsch._tail, (front.hard, cfg, front.batch), {}),
    }[stage]


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
    "Pdsch._decode_front": pdsch_case,
    "PdschSm.encode2": lambda r: sm_encode(r, PdschSm, 2),
    "PdschSm._decode2_front": lambda r: (PdschSm._decode2_front, sm_case(r, PdschSm, 2), {}),
    "PdschSm4.encode2": lambda r: sm_encode(r, PdschSm4, 4),
    "PdschSm4._decode2_front": lambda r: (PdschSm4._decode2_front, sm_case(r, PdschSm4, 4), {}),
    "Pmch._decode_front": pmch_case,
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
    **{f"dlsch.{s}": (lambda r, s=s: cascade_case(s))
       for s in ("_front", "_phase2", "_more", "_phase3", "_phase3b", "_merged", "_tail")},
}


def assert_same(a, b):
    la, lb = [], []
    sa, sb = jit._flatten(a, la), jit._flatten(b, lb)
    assert sa == sb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        else:
            assert x == y


@pytest.mark.parametrize("name", list(CASES))
def test_no_graph_hazards(name):
    """The call as its graph is captured (traced arguments as tensors) meets
    no host read, no upload once its tables are built and no shape that
    depends on the data, and equals the plain eager call."""
    fn, args, kwargs = CASES[name](np.random.default_rng(len(name)))
    assert fn.jit_kind in ("entry", "stage") and not fn.jit_site.segmented
    targs, tkwargs = jit.traced_args(fn, *args, **kwargs)
    fn.__wrapped__(*targs, **tkwargs)  # builds the tables
    with GraphHazards() as mode:
        got = fn.__wrapped__(*targs, **tkwargs)
    assert mode.found == {"read": [], "upload": [], "shape": []}
    assert_same(got, fn.__wrapped__(*args, **kwargs))


def host_reads(run):
    run()
    with GraphHazards() as mode:
        out = run()
    return out, mode.found


def test_cascade_host_reads():
    """`dlsch_decode` reads the host once on a batch whose blocks all pass
    phase 1 and at most three times for one code block size; its branches
    give the decoder's result."""
    c = cascade_inputs()
    cfg, llr = c["cfg"], c["llr"]
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (3, cfg.tbs)).astype(np.uint8)
    clean = (1 - 2.0 * t_dlsch.dlsch_encode(bits, cfg, device="cpu").float()) * -8.0
    (got, ok), found = host_reads(lambda: t_dlsch.dlsch_decode(clean, cfg))
    assert [r.split()[0] for r in found["read"]] == ["tolist"] and not found["upload"] and not found["shape"]
    assert ok.all() and (got.numpy() == bits).all()
    _, found = host_reads(lambda: t_dlsch.dlsch_decode(llr, cfg))
    assert 1 < len(found["read"]) <= 3 and not found["upload"] and not found["shape"]


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
    p, grid, ce, _, scr = sm_case(rng, PdschSm, 2)
    keys = {jit.graph_key(PdschSm._decode2_front, PdschSm(**{
        f: getattr(p, f) for f in p.__dataclass_fields__}), grid, ce, nv, scr) for nv in (0.1, 0.7)}
    keys.add(jit.graph_key(PdschSm._decode2_front, p, grid, ce, 0.3, scr, n_iter=5))
    # the RNTI seeds the descrambling, a traced input: every UE shares the key
    keys.add(jit.graph_key(PdschSm._decode2_front, *sm_case(rng, PdschSm, 2, rnti=0x1234)))
    assert len(keys) == 1
    assert keys != {jit.graph_key(PdschSm._decode2_front, p, grid, ce, 0.3, scr, n_iter=4)}
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
