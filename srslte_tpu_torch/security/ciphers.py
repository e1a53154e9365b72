"""EPS security algorithm dispatch (33.401 Annex B, security.cc equivalent).

cipher_encrypt/decrypt and integrity_mac select EEA0-3/EIA1-3 like
srsran::security_128_eea*/eia* (lib/src/common/security.cc:140-246).
"""

from __future__ import annotations

from .aes import aes128_cmac, aes128_ctr
from .snow3g import eea1 as _eea1, eia1 as _eia1
from .zuc import eea3 as _eea3, eia3 as _eia3

EEA0, EEA1, EEA2, EEA3 = 0, 1, 2, 3
EIA1, EIA2, EIA3 = 1, 2, 3


def _eea2(key: bytes, count: int, bearer: int, direction: int,
          data: bytes) -> bytes:
    ctr0 = (count.to_bytes(4, "big")
            + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2)])
            + bytes(11))
    return aes128_ctr(key, ctr0, data)


def _eia2(key: bytes, count: int, bearer: int, direction: int,
          data: bytes) -> bytes:
    m = (count.to_bytes(4, "big")
         + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2)])
         + bytes(3) + data)
    return aes128_cmac(key, m)[:4]


def cipher_encrypt(algo: int, key: bytes, count: int, bearer: int,
                   direction: int, data: bytes) -> bytes:
    if algo == EEA0:
        return bytes(data)
    if algo == EEA1:
        return _eea1(key, count, bearer, direction, data)
    if algo == EEA2:
        return _eea2(key, count, bearer, direction, data)
    if algo == EEA3:
        return _eea3(key, count, bearer, direction, data)
    raise ValueError(f"unknown EEA{algo}")


def cipher_decrypt(algo: int, key: bytes, count: int, bearer: int,
                   direction: int, data: bytes) -> bytes:
    return cipher_encrypt(algo, key, count, bearer, direction, data)


def integrity_mac(algo: int, key: bytes, count: int, bearer: int,
                  direction: int, data: bytes) -> bytes:
    """4-byte MAC-I."""
    if algo == EIA1:
        # 33.401 B.2.2: FRESH = BEARER << 27
        return _eia1(key, count, (bearer & 0x1F) << 27, direction, data)
    if algo == EIA2:
        return _eia2(key, count, bearer, direction, data)
    if algo == EIA3:
        return _eia3(key, count, bearer, direction, data)
    raise ValueError(f"unknown EIA{algo}")
