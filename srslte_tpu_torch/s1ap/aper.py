"""ALIGNED PER (X.691) combinators — the S1AP wire variant.

Reference behavior: lib/src/asn1/asn1_utils.cc bit_ref engine in its
aligned mode, under the generated 36.413 codecs (lib/src/asn1/s1ap.cc).
S1AP (unlike RRC) uses ALIGNED PER: length determinants, open types, and
multi-octet integers pad to octet boundaries.

Alignment rules implemented (X.691 §10-23, aligned variant):
- constrained int, range 1: nothing; range<=255: bit-field, NO align;
  range==256: one aligned octet; range<=65536: two aligned octets;
  larger: octet-count as bit-field then aligned octets.
- unconstrained int: aligned length det + minimal octets (2's complement).
- length determinant (10.9): aligned; <128 one octet, <16K two octets.
- bit string: fixed <=16 bits unaligned, else aligned contents; variable
  size: constrained-size bit-field then aligned contents.
- octet string: fixed <=2 octets unaligned, else aligned; variable:
  size det then aligned contents.
- open type: aligned length det + whole octets.
- SEQUENCE preamble / CHOICE index / enum index / normally-small ints:
  bit-fields, never aligned.

Values use the same conventions as rrc.per: dict for SEQUENCE,
(name, value) for CHOICE, int for INTEGER/BIT STRING, bytes for OCTET
STRING, str for ENUMERATED / character strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..rrc.per import (BitReader, BitWriter, Type, _bits_for_range,
                       get_small_nonneg, put_small_nonneg)


def put_length_det_aligned(w: BitWriter, n: int):
    w.align()
    if n < 128:
        w.put(n, 8)
    elif n < 16384:
        w.put(0b10, 2)
        w.put(n, 14)
    else:
        raise NotImplementedError("fragmented lengths")


def get_length_det_aligned(r: BitReader) -> int:
    r.align()
    if r.get(1) == 0:
        return r.get(7)
    if r.get(1) == 0:
        return r.get(14)
    raise NotImplementedError("fragmented lengths")


def _put_constrained(w: BitWriter, off: int, rng: int):
    """Constrained whole number (X.691 10.5, ALIGNED)."""
    if rng == 1:
        return
    if rng <= 255:
        w.put(off, _bits_for_range(rng))
    elif rng == 256:
        w.align()
        w.put(off, 8)
    elif rng <= 65536:
        w.align()
        w.put(off, 16)
    else:
        max_octets = (rng - 1).bit_length() + 7 >> 3
        n_oct = max(1, (off.bit_length() + 7) // 8)
        w.put(n_oct - 1, _bits_for_range(max_octets))
        w.align()
        w.put(off, 8 * n_oct)


def _get_constrained(r: BitReader, rng: int) -> int:
    if rng == 1:
        return 0
    if rng <= 255:
        return r.get(_bits_for_range(rng))
    if rng == 256:
        r.align()
        return r.get(8)
    if rng <= 65536:
        r.align()
        return r.get(16)
    max_octets = (rng - 1).bit_length() + 7 >> 3
    n_oct = 1 + r.get(_bits_for_range(max_octets))
    r.align()
    return r.get(8 * n_oct)


@dataclass(frozen=True)
class AInt(Type):
    """INTEGER (lb..ub); ub None = unconstrained above (semi/unconstrained)."""

    lb: int | None = None
    ub: int | None = None
    ext: bool = False

    def pack(self, w, v):
        if self.ext:
            in_root = self.lb is not None and self.lb <= v <= self.ub
            w.put(0 if in_root else 1, 1)
            if not in_root:
                n = max(1, (int(v).bit_length() + 7) // 8)
                put_length_det_aligned(w, n)
                w.put(v, 8 * n)
                return
        if self.lb is None or self.ub is None:
            n = max(1, (int(v - (self.lb or 0)).bit_length() + 7) // 8)
            put_length_det_aligned(w, n)
            w.put(v - (self.lb or 0), 8 * n)
            return
        if not self.lb <= v <= self.ub:
            raise ValueError(f"{v} outside [{self.lb},{self.ub}]")
        _put_constrained(w, v - self.lb, self.ub - self.lb + 1)

    def unpack(self, r):
        if self.ext and r.get(1):
            n = get_length_det_aligned(r)
            return r.get(8 * n)
        if self.lb is None or self.ub is None:
            n = get_length_det_aligned(r)
            return (self.lb or 0) + r.get(8 * n)
        return self.lb + _get_constrained(r, self.ub - self.lb + 1)


@dataclass(frozen=True)
class AEnum(Type):
    names: tuple
    ext: bool = False

    def pack(self, w, v):
        if self.ext:
            w.put(0, 1)
        i = self.names.index(v)
        w.put(i, _bits_for_range(len(self.names)))

    def unpack(self, r):
        if self.ext and r.get(1):
            return f"_ext_{get_small_nonneg(r)}"
        return self.names[r.get(_bits_for_range(len(self.names)))]


def aenum(*names, ext=False):
    return AEnum(tuple(names), ext)


@dataclass(frozen=True)
class ABitStr(Type):
    """BIT STRING (SIZE(lb..ub[, ...])); value int (fixed) or (int, size)."""

    lb: int
    ub: int | None = None
    ext: bool = False

    def pack(self, w, v):
        if self.ext:
            w.put(0, 1)  # extended sizes unsupported on encode
        size = self.lb
        if self.ub is not None and self.ub != self.lb:
            if isinstance(v, tuple):
                v, size = v
            _put_constrained(w, size - self.lb, self.ub - self.lb + 1)
        if size > 16:
            w.align()
        w.put(v, size)

    def unpack(self, r):
        if self.ext and r.get(1):
            raise NotImplementedError("extended BIT STRING size")
        size = self.lb
        if self.ub is not None and self.ub != self.lb:
            size = self.lb + _get_constrained(r, self.ub - self.lb + 1)
        if size > 16:
            r.align()
        v = r.get(size)
        return (v, size) if (self.ub is not None and self.ub != self.lb) \
            else v


@dataclass(frozen=True)
class AOctStr(Type):
    lb: int = 0
    ub: int | None = None  # None = unconstrained

    def pack(self, w, v: bytes):
        if self.ub is not None and self.lb == self.ub:
            if len(v) != self.lb:
                raise ValueError("fixed octet string size mismatch")
            if self.lb > 2:
                w.align()
            w.put_bytes(v)
            return
        if self.ub is not None:
            _put_constrained(w, len(v) - self.lb, self.ub - self.lb + 1)
            w.align()
        else:
            put_length_det_aligned(w, len(v))
        w.put_bytes(v)

    def unpack(self, r):
        if self.ub is not None and self.lb == self.ub:
            if self.lb > 2:
                r.align()
            return r.get_bytes(self.lb)
        if self.ub is not None:
            n = self.lb + _get_constrained(r, self.ub - self.lb + 1)
            r.align()
        else:
            n = get_length_det_aligned(r)
        return r.get_bytes(n)


# PrintableString / UTF8String with known-multiplier octet characters
@dataclass(frozen=True)
class AStr(Type):
    lb: int = 0
    ub: int | None = None
    ext: bool = False

    def pack(self, w, v: str):
        data = v.encode()
        if self.ext:
            w.put(0, 1)
        if self.ub is None:
            put_length_det_aligned(w, len(data))
        else:
            _put_constrained(w, len(data) - self.lb, self.ub - self.lb + 1)
            w.align()
        w.put_bytes(data)

    def unpack(self, r):
        if self.ext and r.get(1):
            raise NotImplementedError("extended string size")
        if self.ub is None:
            n = get_length_det_aligned(r)
        else:
            n = self.lb + _get_constrained(r, self.ub - self.lb + 1)
            r.align()
        return r.get_bytes(n).decode()


@dataclass(frozen=True)
class ASeqOf(Type):
    elem: Type
    lb: int
    ub: int
    ext: bool = False

    def pack(self, w, v):
        if self.ext:
            w.put(0, 1)
        _put_constrained(w, len(v) - self.lb, self.ub - self.lb + 1)
        for x in v:
            self.elem.pack(w, x)

    def unpack(self, r):
        if self.ext and r.get(1):
            raise NotImplementedError("extended SEQUENCE OF size")
        n = self.lb + _get_constrained(r, self.ub - self.lb + 1)
        return [self.elem.unpack(r) for _ in range(n)]


_MISSING = object()


@dataclass(frozen=True)
class AF:
    name: str
    typ: Type
    optional: bool = False
    default: Any = _MISSING

    @property
    def has_presence_bit(self) -> bool:
        return self.optional or self.default is not _MISSING


@dataclass(frozen=True)
class ASeq(Type):
    fields: tuple
    ext: bool = False

    def pack(self, w, v: dict):
        unknown = set(v) - {f.name for f in self.fields}
        if unknown:
            raise ValueError(f"unknown fields {unknown}")
        if self.ext:
            w.put(0, 1)
        for f in self.fields:
            if f.has_presence_bit:
                w.put(1 if f.name in v else 0, 1)
        for f in self.fields:
            if f.name in v:
                f.typ.pack(w, v[f.name])
            elif not f.has_presence_bit:
                raise ValueError(f"missing mandatory field {f.name}")

    def unpack(self, r):
        has_ext = bool(self.ext and r.get(1))
        present = [(not f.has_presence_bit) or bool(r.get(1))
                   for f in self.fields]
        out = {}
        for f, p in zip(self.fields, present):
            if p:
                out[f.name] = f.typ.unpack(r)
        if has_ext:
            n = get_small_nonneg(r) + 1
            flags = [r.get(1) for _ in range(n)]
            out["_ext"] = [
                r.get_bytes(get_length_det_aligned(r)) if fl else None
                for fl in flags]
        return out


@dataclass(frozen=True)
class AChoice(Type):
    alts: tuple
    ext: bool = False

    def pack(self, w, v):
        name, val = v
        if self.ext:
            if name.startswith("_ext_"):
                w.put(1, 1)
                put_small_nonneg(w, int(name[5:]))
                put_length_det_aligned(w, len(val))
                w.put_bytes(val)
                return
            w.put(0, 1)
        names = [n for n, _ in self.alts]
        i = names.index(name)
        _put_constrained(w, i, len(self.alts))
        dict(self.alts)[name].pack(w, val)

    def unpack(self, r):
        if self.ext and r.get(1):
            i = get_small_nonneg(r)
            return (f"_ext_{i}", r.get_bytes(get_length_det_aligned(r)))
        i = _get_constrained(r, len(self.alts))
        name, typ = self.alts[i]
        return (name, typ.unpack(r))


def aseq(*fields, ext=False):
    return ASeq(tuple(fields), ext)


def achoice(*alts, ext=False):
    return AChoice(tuple(alts), ext)


@dataclass(frozen=True)
class OpenType(Type):
    """Open type (X.691 10.2): aligned length det + contents octets."""

    inner: Type

    def pack(self, w, v):
        data = self.inner.to_bytes(v)
        put_length_det_aligned(w, len(data))
        w.put_bytes(data)

    def unpack(self, r):
        n = get_length_det_aligned(r)
        return self.inner.from_bytes(r.get_bytes(n))
