"""SNOW 3G stream cipher (UEA2/UIA2, 3GPP 35.216) — EEA1/EIA1 core.

Reference behavior: lib/src/common/s3g.cc (LFSR + FSM per the SAGE spec,
f8/f9 wrappers with the 33.401 key/IV mappings).  The S-boxes: S1 uses the
AES S-box, S2 the spec's SQ Dickson-polynomial box (spec constant table).
"""

from __future__ import annotations

from .aes import _init_tables

M32 = 0xFFFFFFFF

# 35.216 SQ S-box (spec constant, section 3.4.2)
SQ = bytes([
    0x25, 0x24, 0x73, 0x67, 0xD7, 0xAE, 0x5C, 0x30, 0xA4, 0xEE, 0x6E, 0xCB,
    0x7D, 0xB5, 0x82, 0xDB, 0xE4, 0x8E, 0x48, 0x49, 0x4F, 0x5D, 0x6A, 0x78,
    0x70, 0x88, 0xE8, 0x5F, 0x5E, 0x84, 0x65, 0xE2, 0xD8, 0xE9, 0xCC, 0xED,
    0x40, 0x2F, 0x11, 0x28, 0x57, 0xD2, 0xAC, 0xE3, 0x4A, 0x15, 0x1B, 0xB9,
    0xB2, 0x80, 0x85, 0xA6, 0x2E, 0x02, 0x47, 0x29, 0x07, 0x4B, 0x0E, 0xC1,
    0x51, 0xAA, 0x89, 0xD4, 0xCA, 0x01, 0x46, 0xB3, 0xEF, 0xDD, 0x44, 0x7B,
    0xC2, 0x7F, 0xBE, 0xC3, 0x9F, 0x20, 0x4C, 0x64, 0x83, 0xA2, 0x68, 0x42,
    0x13, 0xB4, 0x41, 0xCD, 0xBA, 0xC6, 0xBB, 0x6D, 0x4D, 0x71, 0x21, 0xF4,
    0x8D, 0xB0, 0xE5, 0x93, 0xFE, 0x8F, 0xE6, 0xCF, 0x43, 0x45, 0x31, 0x22,
    0x37, 0x36, 0x96, 0xFA, 0xBC, 0x0F, 0x08, 0x52, 0x1D, 0x55, 0x1A, 0xC5,
    0x4E, 0x23, 0x69, 0x7A, 0x92, 0xFF, 0x5B, 0x5A, 0xEB, 0x9A, 0x1C, 0xA9,
    0xD1, 0x7E, 0x0D, 0xFC, 0x50, 0x8A, 0xB6, 0x62, 0xF5, 0x0A, 0xF8, 0xDC,
    0x03, 0x3C, 0x0C, 0x39, 0xF1, 0xB8, 0xF3, 0x3D, 0xF2, 0xD5, 0x97, 0x66,
    0x81, 0x32, 0xA0, 0x00, 0x06, 0xCE, 0xF6, 0xEA, 0xB7, 0x17, 0xF7, 0x8C,
    0x79, 0xD6, 0xA7, 0xBF, 0x8B, 0x3F, 0x1F, 0x53, 0x63, 0x75, 0x35, 0x2C,
    0x60, 0xFD, 0x27, 0xD3, 0x94, 0xA5, 0x7C, 0xA1, 0x05, 0x58, 0x2D, 0xBD,
    0xD9, 0xC7, 0xAF, 0x6B, 0x54, 0x0B, 0xE0, 0x38, 0x04, 0xC8, 0x9D, 0xE7,
    0x14, 0xB1, 0x87, 0x9C, 0xDF, 0x6F, 0xF9, 0xDA, 0x2A, 0xC4, 0x59, 0x16,
    0x74, 0x91, 0xAB, 0x26, 0x61, 0x76, 0x34, 0x2B, 0xAD, 0x99, 0xFB, 0x72,
    0xEC, 0x33, 0x12, 0xDE, 0x98, 0x3B, 0xC0, 0x9B, 0x3E, 0x18, 0x10, 0x3A,
    0x56, 0xE1, 0x77, 0xC9, 0x1E, 0x9E, 0x95, 0xA3, 0x90, 0x19, 0xA8, 0x6C,
    0x09, 0xD0, 0xF0, 0x86,
])
assert len(SQ) == 256


def _mulx(v: int, c: int) -> int:
    return ((v << 1) ^ c) & 0xFF if v & 0x80 else (v << 1) & 0xFF


def _mulxpow(v: int, i: int, c: int) -> int:
    for _ in range(i):
        v = _mulx(v, c)
    return v


def _mul_a(c: int) -> int:
    return ((_mulxpow(c, 23, 0xA9) << 24) | (_mulxpow(c, 245, 0xA9) << 16)
            | (_mulxpow(c, 48, 0xA9) << 8) | _mulxpow(c, 239, 0xA9))


def _div_a(c: int) -> int:
    return ((_mulxpow(c, 16, 0xA9) << 24) | (_mulxpow(c, 39, 0xA9) << 16)
            | (_mulxpow(c, 6, 0xA9) << 8) | _mulxpow(c, 64, 0xA9))


_MULA = [_mul_a(c) for c in range(256)]
_DIVA = [_div_a(c) for c in range(256)]


def _sbox_layer(w: int, box, c: int) -> int:
    b = [(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF]
    s = [box[x] for x in b]
    r0 = _mulx(s[0], c) ^ s[1] ^ s[2] ^ _mulx(s[3], c) ^ s[3]
    r1 = _mulx(s[0], c) ^ s[0] ^ _mulx(s[1], c) ^ s[2] ^ s[3]
    r2 = s[0] ^ _mulx(s[1], c) ^ s[1] ^ _mulx(s[2], c) ^ s[3]
    r3 = s[0] ^ s[1] ^ _mulx(s[2], c) ^ s[2] ^ _mulx(s[3], c)
    return (r0 << 24) | (r1 << 16) | (r2 << 8) | r3


def _aes_sbox():
    from . import aes

    _init_tables()
    return aes._SBOX


class Snow3G:
    def __init__(self, k: list, iv: list):
        """k, iv: 4 words each, in the s3g.cc array convention."""
        self._s1box = _aes_sbox()
        s = [0] * 16
        ones = M32
        s[15], s[14], s[13], s[12] = k[3] ^ iv[0], k[2], k[1], k[0] ^ iv[1]
        s[11], s[10] = k[3] ^ ones, k[2] ^ ones ^ iv[2]
        s[9], s[8] = k[1] ^ ones ^ iv[3], k[0] ^ ones
        s[7], s[6], s[5], s[4] = k[3], k[2], k[1], k[0]
        s[3], s[2], s[1], s[0] = (k[3] ^ ones, k[2] ^ ones, k[1] ^ ones,
                                  k[0] ^ ones)
        self.lfsr = s
        self.r1 = self.r2 = self.r3 = 0
        for _ in range(32):
            f = self._clock_fsm()
            self._clock_lfsr(f)

    def _clock_fsm(self) -> int:
        f = ((self.lfsr[15] + self.r1) & M32) ^ self.r2
        r = (self.r2 + (self.r3 ^ self.lfsr[5])) & M32
        self.r3 = _sbox_layer(self.r2, SQ, 0x69)
        self.r2 = _sbox_layer(self.r1, self._s1box, 0x1B)
        self.r1 = r
        return f

    def _clock_lfsr(self, f: int):
        s = self.lfsr
        v = (((s[0] << 8) & 0xFFFFFF00) ^ _MULA[(s[0] >> 24) & 0xFF]
             ^ s[2] ^ (s[11] >> 8) ^ _DIVA[s[11] & 0xFF] ^ f) & M32
        self.lfsr = s[1:] + [v]

    def keystream(self, n: int) -> list:
        self._clock_fsm()
        self._clock_lfsr(0)
        out = []
        for _ in range(n):
            f = self._clock_fsm()
            out.append(f ^ self.lfsr[0])
            self._clock_lfsr(0)
        return out


def _key_words(key: bytes) -> list:
    """key bytes -> k[] in the s3g.cc convention (k[3] = first 4 bytes)."""
    w = [int.from_bytes(key[4 * i : 4 * i + 4], "big") for i in range(4)]
    return [w[3], w[2], w[1], w[0]]


def eea1(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """128-EEA1 keystream cipher (33.401 B.1.2); involution.

    IV convention follows 35.215: the array index pairs with the LFSR as in
    Snow3G.__init__ (iv[0] -> s15): iv = [bearer|dir, count, bearer|dir,
    count].
    """
    bd = ((bearer & 0x1F) << 27) | ((direction & 1) << 26)
    iv = [bd, count, bd, count]
    n_words = (len(data) + 3) // 4
    ks = Snow3G(_key_words(key), iv).keystream(n_words)
    stream = b"".join(w.to_bytes(4, "big") for w in ks)[: len(data)]
    return bytes(a ^ b for a, b in zip(data, stream))


def _mul64x(v: int, c: int) -> int:
    if v & (1 << 63):
        return ((v << 1) & ((1 << 64) - 1)) ^ c
    return (v << 1) & ((1 << 64) - 1)


def _mul64(v: int, p: int, c: int) -> int:
    """MUL64 (35.216 §4.3.2): sum of V*x^i over set bits i of P in GF(2^64)."""
    r = 0
    for i in range(64):
        if (p >> i) & 1:
            r ^= v
        v = _mul64x(v, c)
    return r


def eia1(key: bytes, count: int, fresh: int, direction: int, data: bytes,
         length_bits: int | None = None) -> bytes:
    """128-EIA1 / UIA2 f9 MAC (35.216 §4.4): 4-byte MAC-I.

    For 128-EIA1 (33.401 B.2.2): fresh = bearer << 27.
    """
    length = length_bits if length_bits is not None else 8 * len(data)
    iv = [fresh ^ ((direction & 1) << 15), count ^ ((direction & 1) << 31),
          fresh, count]
    z = Snow3G(_key_words(key), iv).keystream(5)
    p = (z[0] << 32) | z[1]
    q = (z[2] << 32) | z[3]
    d = (length >> 6) + (1 if length % 64 == 0 else 2)
    ev = 0
    c = 0x1B
    for i in range(d - 2):
        v = ev ^ int.from_bytes(data[8 * i : 8 * i + 8], "big")
        ev = _mul64(v, p, c)
    rem = length % 64 or 64
    chunk = data[8 * (d - 2) : 8 * (d - 2) + (rem + 7) // 8]
    m = int.from_bytes(chunk.ljust(8, b"\0"), "big")
    keep = ((1 << rem) - 1) << (64 - rem)
    ev = _mul64(ev ^ (m & keep), p, c)
    ev ^= length
    ev = _mul64(ev, q, c)
    mac = (ev >> 32) ^ z[4]
    return int(mac & M32).to_bytes(4, "big")
