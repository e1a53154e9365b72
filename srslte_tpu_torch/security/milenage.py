"""Milenage AKA functions f1-f5* (3GPP 35.206).

Reference behavior: lib/src/common/liblte_security.cc (compute_opc, f1-f5*)
and srsepc/src/hss/hss.cc usage for auth-vector generation.
"""

from __future__ import annotations

from .aes import aes128_encrypt_block

_R = (64, 0, 32, 64, 96)
_C = (0, 1, 2, 4, 8)


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _rot(x: bytes, bits: int) -> bytes:
    n = bits // 8
    return x[n:] + x[:n]


def compute_opc(k: bytes, op: bytes) -> bytes:
    return _xor(aes128_encrypt_block(k, op), op)


def _out(k: bytes, temp: bytes, opc: bytes, idx: int) -> bytes:
    c = bytes(15) + bytes([_C[idx]])
    inner = _xor(_rot(_xor(temp, opc), _R[idx]), c)
    return _xor(aes128_encrypt_block(k, inner), opc)


def milenage_f1(k: bytes, opc: bytes, rand: bytes, sqn: bytes,
                amf: bytes) -> tuple[bytes, bytes]:
    """-> (MAC-A, MAC-S)."""
    temp = aes128_encrypt_block(k, _xor(rand, opc))
    in1 = sqn + amf + sqn + amf
    inner = _xor(_rot(_xor(in1, opc), _R[0]), bytes(15) + bytes([_C[0]]))
    out1 = _xor(aes128_encrypt_block(k, _xor(temp, inner)), opc)
    return out1[:8], out1[8:]


def milenage_f2345(k: bytes, opc: bytes, rand: bytes):
    """-> (RES, CK, IK, AK) per 35.206 f2-f5."""
    temp = aes128_encrypt_block(k, _xor(rand, opc))
    out2 = _out(k, temp, opc, 1)
    out3 = _out(k, temp, opc, 2)
    out4 = _out(k, temp, opc, 3)
    res, ak = out2[8:], out2[:6]
    return res, out3, out4, ak


def milenage_f5_star(k: bytes, opc: bytes, rand: bytes) -> bytes:
    temp = aes128_encrypt_block(k, _xor(rand, opc))
    return _out(k, temp, opc, 4)[:6]
