"""UNALIGNED PER (X.691) codec core + declarative ASN.1 schema combinators.

Reference behavior: lib/src/asn1/asn1_utils.cc (bit_ref pack/unpack engine
under the generated 36.331 codecs).  RRC uses the UNALIGNED PER variant:
everything is a bit field, no octet alignment anywhere except inside
"contained" open types (which are octet strings of whole bytes).

The schema layer is declarative: message definitions are trees of the
combinators below (Seq/Choice/Int/Enum/...) packing plain Python values
(dict for Seq, (name, value) for Choice), so the 36.331 subset reads like
the ASN.1 itself.  pack -> bytes; unpack -> value tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def put(self, value: int, nbits: int):
        if nbits < 0 or (nbits and value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        for i in range(nbits - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def put_bytes(self, data: bytes):
        for b in data:
            self.put(b, 8)

    def align(self):
        """Pad to an octet boundary (ALIGNED PER only)."""
        self._bits.extend([0] * (-len(self._bits) % 8))

    @property
    def nbits(self) -> int:
        return len(self._bits)

    def to_bytes(self) -> bytes:
        bits = self._bits + [0] * (-len(self._bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            v = 0
            for b in bits[i : i + 8]:
                v = (v << 1) | b
            out.append(v)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self.pos = 0

    def get(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self._data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def get_bytes(self, n: int) -> bytes:
        return bytes(self.get(8) for _ in range(n))

    def align(self):
        """Skip to an octet boundary (ALIGNED PER only)."""
        self.pos += -self.pos % 8

    @property
    def bits_left(self) -> int:
        return len(self._data) * 8 - self.pos


def _bits_for_range(n: int) -> int:
    """ceil(log2(n)) for a range of n values (X.691 10.5.3)."""
    return max(0, (n - 1).bit_length())


def put_length_det(w: BitWriter, n: int):
    """General length determinant, unconstrained (X.691 10.9, unaligned:
    same format as aligned but without padding)."""
    if n < 128:
        w.put(n, 8)
    elif n < 16384:
        w.put(0b10, 2)
        w.put(n, 14)
    else:
        raise NotImplementedError("fragmented lengths")


def get_length_det(r: BitReader) -> int:
    first = r.get(1)
    if first == 0:
        return r.get(7)
    if r.get(1) == 0:
        return r.get(14)
    raise NotImplementedError("fragmented lengths")


def put_small_nonneg(w: BitWriter, n: int):
    """Normally-small non-negative whole number (X.691 10.6): extension
    choice/addition indices."""
    if n < 64:
        w.put(0, 1)
        w.put(n, 6)
    else:
        w.put(1, 1)
        put_length_det(w, _octets_for(n))
        w.put(n, 8 * _octets_for(n))


def get_small_nonneg(r: BitReader) -> int:
    if r.get(1) == 0:
        return r.get(6)
    n = get_length_det(r)
    return r.get(8 * n)


def _octets_for(v: int) -> int:
    return max(1, (v.bit_length() + 7) // 8)


# --------------------------------------------------------------- combinators

class Type:
    def pack(self, w: BitWriter, v):  # pragma: no cover - interface
        raise NotImplementedError

    def unpack(self, r: BitReader):  # pragma: no cover - interface
        raise NotImplementedError

    def to_bytes(self, v) -> bytes:
        w = BitWriter()
        self.pack(w, v)
        return w.to_bytes()

    def from_bytes(self, data: bytes):
        return self.unpack(BitReader(data))


@dataclass(frozen=True)
class Int(Type):
    """Constrained whole number [lb, ub] (X.691 10.5: unaligned PER packs
    the offset in ceil(log2(range)) bits, never octet-aligned)."""

    lb: int
    ub: int

    def pack(self, w, v):
        if not self.lb <= v <= self.ub:
            raise ValueError(f"{v} outside [{self.lb},{self.ub}]")
        w.put(v - self.lb, _bits_for_range(self.ub - self.lb + 1))

    def unpack(self, r):
        return self.lb + r.get(_bits_for_range(self.ub - self.lb + 1))


@dataclass(frozen=True)
class Bool(Type):
    def pack(self, w, v):
        w.put(1 if v else 0, 1)

    def unpack(self, r):
        return bool(r.get(1))


@dataclass(frozen=True)
class Null(Type):
    def pack(self, w, v):
        pass

    def unpack(self, r):
        return None


@dataclass(frozen=True)
class Enum(Type):
    """ENUMERATED; names in root order.  ext=True adds the extension bit."""

    names: tuple
    ext: bool = False

    def pack(self, w, v):
        if self.ext:
            w.put(0, 1)  # extension values unsupported on encode
        try:
            i = self.names.index(v)
        except ValueError:
            raise ValueError(f"enum value {v!r} not in {self.names}")
        w.put(i, _bits_for_range(len(self.names)))

    def unpack(self, r):
        if self.ext and r.get(1):
            return f"_ext_{get_small_nonneg(r)}"
        return self.names[r.get(_bits_for_range(len(self.names)))]


def enum(*names, ext=False):
    return Enum(tuple(names), ext)


@dataclass(frozen=True)
class BitStr(Type):
    """Fixed-size or constrained-size bit string, value = int."""

    lb: int
    ub: int | None = None  # None = fixed size lb

    def pack(self, w, v):
        size = self.lb
        if self.ub is not None and self.ub != self.lb:
            if isinstance(v, tuple):
                size, v = v[1], v[0]
            w.put(size - self.lb, _bits_for_range(self.ub - self.lb + 1))
        w.put(v, size)

    def unpack(self, r):
        size = self.lb
        if self.ub is not None and self.ub != self.lb:
            size = self.lb + r.get(_bits_for_range(self.ub - self.lb + 1))
        v = r.get(size)
        if self.ub is not None and self.ub != self.lb:
            return (v, size)
        return v


@dataclass(frozen=True)
class OctStr(Type):
    """OCTET STRING; fixed size (lb=ub) or variable with length det."""

    lb: int = 0
    ub: int | None = None  # None = unconstrained

    def pack(self, w, v: bytes):
        if self.ub is not None and self.lb == self.ub:
            if len(v) != self.lb:
                raise ValueError("fixed octet string size mismatch")
            w.put_bytes(v)
            return
        if self.ub is not None:
            w.put(len(v) - self.lb, _bits_for_range(self.ub - self.lb + 1))
        else:
            put_length_det(w, len(v))
        w.put_bytes(v)

    def unpack(self, r):
        if self.ub is not None and self.lb == self.ub:
            return r.get_bytes(self.lb)
        if self.ub is not None:
            n = self.lb + r.get(_bits_for_range(self.ub - self.lb + 1))
        else:
            n = get_length_det(r)
        return r.get_bytes(n)


@dataclass(frozen=True)
class SeqOf(Type):
    elem: Type
    lb: int
    ub: int

    def pack(self, w, v):
        if not self.lb <= len(v) <= self.ub:
            raise ValueError("SEQUENCE OF size out of range")
        if self.ub != self.lb:
            w.put(len(v) - self.lb, _bits_for_range(self.ub - self.lb + 1))
        for x in v:
            self.elem.pack(w, x)

    def unpack(self, r):
        n = self.lb
        if self.ub != self.lb:
            n = self.lb + r.get(_bits_for_range(self.ub - self.lb + 1))
        return [self.elem.unpack(r) for _ in range(n)]


_MISSING = object()

TRACE: list | None = None  # set to a list to log (path, bitpos) during unpack


def _trace(name, r):
    if TRACE is not None:
        TRACE.append((name, r.pos))


@dataclass(frozen=True)
class F:
    """A SEQUENCE field: name + type (+ OPTIONAL/DEFAULT)."""

    name: str
    typ: Type
    optional: bool = False
    default: Any = _MISSING

    @property
    def has_presence_bit(self) -> bool:
        return self.optional or self.default is not _MISSING


@dataclass(frozen=True)
class Seq(Type):
    """SEQUENCE: values are dicts; omit optional fields to skip them."""

    fields: tuple
    ext: bool = False

    def pack(self, w, v: dict):
        exts = v.get("_ext")
        unknown = set(v) - {f.name for f in self.fields} - {"_ext"}
        if unknown:
            raise ValueError(f"unknown fields {unknown}")
        if self.ext:
            w.put(1 if exts else 0, 1)
        for f in self.fields:
            if f.has_presence_bit:
                w.put(1 if f.name in v else 0, 1)
        for f in self.fields:
            if f.name in v:
                f.typ.pack(w, v[f.name])
            elif not f.has_presence_bit:
                raise ValueError(f"missing mandatory field {f.name}")
        if exts:
            # extension additions (X.691 18.7-18.9): normally-small bitmap
            # length, presence flags, then each present addition as an open
            # type.  exts is the list of raw open-type byte strings captured
            # at decode (None = addition absent).
            put_small_nonneg(w, len(exts) - 1)
            for e in exts:
                w.put(0 if e is None else 1, 1)
            for e in exts:
                if e is not None:
                    put_length_det(w, len(e))
                    w.put_bytes(e)

    def unpack(self, r):
        has_ext = bool(self.ext and r.get(1))
        present = {}
        for f in self.fields:
            present[f.name] = (not f.has_presence_bit) or bool(r.get(1))
        out = {}
        for f in self.fields:
            if present[f.name]:
                _trace(f.name, r)
                out[f.name] = f.typ.unpack(r)
        if has_ext:
            # extension additions preserved as raw open-type bytes so that
            # re-encoding round-trips messages with additions we don't model
            n = get_small_nonneg(r) + 1
            flags = [r.get(1) for _ in range(n)]
            out["_ext"] = [
                r.get_bytes(get_length_det(r)) if fl else None for fl in flags
            ]
        return out


@dataclass(frozen=True)
class Choice(Type):
    """CHOICE: values are (name, value) tuples."""

    alts: tuple  # of (name, Type)
    ext: bool = False

    def pack(self, w, v):
        name, val = v
        if self.ext and name.startswith("_ext_"):
            # re-emit a preserved extension alternative (raw open type)
            w.put(1, 1)
            put_small_nonneg(w, int(name[5:]))
            put_length_det(w, len(val))
            w.put_bytes(val)
            return
        names = [n for n, _ in self.alts]
        if name not in names:
            raise ValueError(f"choice alternative {name!r} not in {names}")
        if self.ext:
            w.put(0, 1)
        i = names.index(name)
        w.put(i, _bits_for_range(len(self.alts)))
        dict(self.alts)[name].pack(w, val)

    def unpack(self, r):
        if self.ext and r.get(1):
            i = get_small_nonneg(r)
            ln = get_length_det(r)
            return (f"_ext_{i}", r.get_bytes(ln))
        i = r.get(_bits_for_range(len(self.alts)))
        name, typ = self.alts[i]
        _trace("<" + name + ">", r)
        return (name, typ.unpack(r))


def choice(*alts, ext=False):
    return Choice(tuple(alts), ext)


def seq(*fields, ext=False):
    return Seq(tuple(fields), ext)


@dataclass(frozen=True)
class Contained(Type):
    """An open type / contained constraint: inner type packed into a
    whole-octet string with a general length determinant (e.g.
    criticalExtensionsFuture, DedicatedInfoNAS carriers use OctStr; this is
    for CONTAINING constraints)."""

    inner: Type

    def pack(self, w, v):
        data = self.inner.to_bytes(v)
        put_length_det(w, len(data))
        w.put_bytes(data)

    def unpack(self, r):
        n = get_length_det(r)
        return self.inner.from_bytes(r.get_bytes(n))
