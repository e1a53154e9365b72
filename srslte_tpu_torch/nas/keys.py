"""EPS key derivation functions (33.401 Annex A).

Reference behavior: lib/src/common/security.cc KDF chain used by
srsue/src/stack/upper/nas.cc and srsepc/src/mme/nas.cc.
"""

from __future__ import annotations

import hashlib
import hmac


def _kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    s = bytes([fc])
    for p in params:
        s += p + len(p).to_bytes(2, "big")
    return hmac.new(key, s, hashlib.sha256).digest()


def kdf_kasme(ck: bytes, ik: bytes, plmn: bytes, sqn_xor_ak: bytes) -> bytes:
    """K_ASME (A.2): KDF(CK||IK, FC=0x10, SN id, SQN^AK)."""
    return _kdf(ck + ik, 0x10, plmn, sqn_xor_ak)


def kdf_nas_keys(kasme: bytes, ea: int, ia: int) -> tuple[bytes, bytes]:
    """(K_NASenc, K_NASint) (A.7): 128 LSBs of the 256-bit KDF output."""
    k_enc = _kdf(kasme, 0x15, bytes([0x01]), bytes([ea]))[16:]
    k_int = _kdf(kasme, 0x15, bytes([0x02]), bytes([ia]))[16:]
    return k_enc, k_int


def kdf_kenb(kasme: bytes, ul_count: int) -> bytes:
    """K_eNB (A.3)."""
    return _kdf(kasme, 0x11, ul_count.to_bytes(4, "big"))


def kdf_as_keys(kenb: bytes, ea: int, ia: int) -> tuple[bytes, bytes]:
    """(K_RRCenc/K_UPenc style) AS keys (A.7 with RRC/UP distinguishers)."""
    k_up = _kdf(kenb, 0x15, bytes([0x05]), bytes([ea]))[16:]
    k_rrc_int = _kdf(kenb, 0x15, bytes([0x04]), bytes([ia]))[16:]
    return k_up, k_rrc_int
