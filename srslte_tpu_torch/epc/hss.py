"""HSS: subscriber database + Milenage auth vectors (srsepc/src/hss/hss.cc).

Reference behavior: user_db.csv subscriber store, EPS auth vector generation
(RAND, XRES, AUTN, K_ASME) via Milenage, SQN management.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..nas.keys import kdf_kasme
from ..security.milenage import compute_opc, milenage_f1, milenage_f2345


@dataclass
class Subscriber:
    imsi: str
    key: bytes
    opc: bytes
    sqn: int = 0


@dataclass
class Hss:
    plmn: bytes = bytes.fromhex("00f110")  # MCC 001 / MNC 01 packed
    subscribers: dict = field(default_factory=dict)

    def add_subscriber(self, imsi: str, key: bytes, op: bytes | None = None,
                       opc: bytes | None = None):
        if opc is None:
            opc = compute_opc(key, op)
        self.subscribers[imsi] = Subscriber(imsi, key, opc)

    def load_csv(self, path: str):
        """user_db.csv style: imsi,key_hex,opc_hex per line."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                imsi, k, opc = line.split(",")[:3]
                self.subscribers[imsi] = Subscriber(
                    imsi, bytes.fromhex(k), bytes.fromhex(opc))

    def auth_vector(self, imsi: str, rand: bytes | None = None):
        """-> (rand, xres, autn, kasme) or None for unknown IMSI."""
        sub = self.subscribers.get(imsi)
        if sub is None:
            return None
        rand = rand or os.urandom(16)
        sub.sqn += 32
        sqn = sub.sqn.to_bytes(6, "big")
        amf = b"\x80\x00"
        mac_a, _ = milenage_f1(sub.key, sub.opc, rand, sqn, amf)
        xres, ck, ik, ak = milenage_f2345(sub.key, sub.opc, rand)
        sqn_xor_ak = bytes(a ^ b for a, b in zip(sqn, ak))
        autn = sqn_xor_ak + amf + mac_a
        kasme = kdf_kasme(ck, ik, self.plmn, sqn_xor_ak)
        return rand, xres, autn, kasme
