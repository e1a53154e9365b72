"""TFT packet filters: uplink IP-packet -> EPS-bearer matching.

Reference behavior: srsue/src/stack/upper/tft_packet_filter.cc — parse the
24.008 §10.5.6.12 packet-filter component list (IPv4/IPv6 address+mask,
single ports / port ranges with order normalization, protocol id, type of
service, flow label, IPsec SPI), then match outgoing packets: every active
component class must match for the filter to hit; the matcher evaluates
filters by ascending evaluation precedence and falls back to the default
bearer (gw.cc:343 check_tft_filter_match).

Host-side pure Python: this classifies packets on the TUN/GW path before
they enter the device pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# component type identifiers (24.008 table 10.5.162)
IPV4_REMOTE_ADDR = 0x10
IPV4_LOCAL_ADDR = 0x11
IPV6_REMOTE_ADDR = 0x20
IPV6_REMOTE_ADDR_LEN = 0x21
IPV6_LOCAL_ADDR_LEN = 0x23
PROTOCOL_ID = 0x30
SINGLE_LOCAL_PORT = 0x40
LOCAL_PORT_RANGE = 0x41
SINGLE_REMOTE_PORT = 0x50
REMOTE_PORT_RANGE = 0x51
SECURITY_PARAMETER_INDEX = 0x60
TYPE_OF_SERVICE = 0x70
FLOW_LABEL = 0x80

_UDP, _TCP = 17, 6


def _prefix_mask(nbits: int) -> bytes:
    full, rem = divmod(nbits, 8)
    out = b"\xff" * full
    if rem:
        out += bytes([0xFF & ~((1 << (8 - rem)) - 1)])
    return out.ljust(16, b"\x00")


@dataclass
class TftFilter:
    """One parsed packet filter bound to an EPS bearer / LCID."""

    eps_bearer_id: int
    lcid: int
    id: int = 0
    eval_precedence: int = 255
    # parsed components (None = inactive)
    ipv4_local: tuple | None = None  # (addr bytes, mask bytes)
    ipv4_remote: tuple | None = None
    ipv6_remote: tuple | None = None  # (addr bytes, mask bytes, length)
    ipv6_local: tuple | None = None
    protocol_id: int | None = None
    single_local_port: int | None = None
    local_port_range: tuple | None = None
    single_remote_port: int | None = None
    remote_port_range: tuple | None = None
    type_of_service: tuple | None = None  # (tos, mask)
    flow_label: bytes | None = None
    spi: bytes | None = None

    @classmethod
    def parse(cls, eps_bearer_id: int, lcid: int, components: bytes,
              filter_id: int = 0, eval_precedence: int = 255) -> "TftFilter":
        f = cls(eps_bearer_id, lcid, filter_id, eval_precedence)
        # bytes each component type consumes after its type octet
        need = {IPV4_LOCAL_ADDR: 8, IPV4_REMOTE_ADDR: 8, IPV6_REMOTE_ADDR: 32,
                IPV6_REMOTE_ADDR_LEN: 17, IPV6_LOCAL_ADDR_LEN: 17,
                PROTOCOL_ID: 1, SINGLE_LOCAL_PORT: 2, SINGLE_REMOTE_PORT: 2,
                LOCAL_PORT_RANGE: 4, REMOTE_PORT_RANGE: 4,
                TYPE_OF_SERVICE: 2, FLOW_LABEL: 3,
                SECURITY_PARAMETER_INDEX: 4}
        i = 0
        while i < len(components):
            t = components[i]
            i += 1
            if t in need and len(components) - i < need[t]:
                # reject malformed remote input at parse time — a silently
                # short slice would crash match() on the data plane later
                raise ValueError(f"truncated TFT component 0x{t:02x}")
            if t == IPV4_LOCAL_ADDR:
                f.ipv4_local = (components[i : i + 4],
                                components[i + 4 : i + 8])
                i += 8
            elif t == IPV4_REMOTE_ADDR:
                f.ipv4_remote = (components[i : i + 4],
                                 components[i + 4 : i + 8])
                i += 8
            elif t == IPV6_REMOTE_ADDR:
                f.ipv6_remote = (components[i : i + 16],
                                 components[i + 16 : i + 32], 16)
                i += 32
            elif t == IPV6_REMOTE_ADDR_LEN:
                addr = components[i : i + 16]
                n = components[i + 16]
                f.ipv6_remote = (addr, _prefix_mask(n), (n + 7) // 8)
                i += 17
            elif t == IPV6_LOCAL_ADDR_LEN:
                addr = components[i : i + 16]
                n = components[i + 16]
                f.ipv6_local = (addr, _prefix_mask(n), (n + 7) // 8)
                i += 17
            elif t == PROTOCOL_ID:
                f.protocol_id = components[i]
                i += 1
            elif t == SINGLE_LOCAL_PORT:
                f.single_local_port = int.from_bytes(components[i : i + 2],
                                                     "big")
                i += 2
            elif t == SINGLE_REMOTE_PORT:
                f.single_remote_port = int.from_bytes(components[i : i + 2],
                                                      "big")
                i += 2
            elif t == LOCAL_PORT_RANGE:
                a = int.from_bytes(components[i : i + 2], "big")
                b = int.from_bytes(components[i + 2 : i + 4], "big")
                f.local_port_range = (min(a, b), max(a, b))
                i += 4
            elif t == REMOTE_PORT_RANGE:
                a = int.from_bytes(components[i : i + 2], "big")
                b = int.from_bytes(components[i + 2 : i + 4], "big")
                f.remote_port_range = (min(a, b), max(a, b))
                i += 4
            elif t == TYPE_OF_SERVICE:
                f.type_of_service = (components[i], components[i + 1])
                i += 2
            elif t == FLOW_LABEL:
                # spare high nibble of the first octet 'shall be ignored'
                # (24.008) — mask it so it can never block a match
                f.flow_label = (bytes([components[i] & 0x0F])
                                + components[i + 1 : i + 3])
                i += 3
            elif t == SECURITY_PARAMETER_INDEX:
                f.spi = components[i : i + 4]
                i += 4
            else:
                raise ValueError(f"unknown TFT component type 0x{t:02x}")
        return f

    # -- matching (outgoing packets) -----------------------------------------
    @property
    def _active(self) -> bool:
        return any(x is not None for x in (
            self.ipv4_local, self.ipv4_remote, self.ipv6_remote,
            self.ipv6_local, self.protocol_id, self.single_local_port,
            self.local_port_range, self.single_remote_port,
            self.remote_port_range, self.type_of_service, self.flow_label,
            self.spi))

    def match(self, pkt: bytes) -> bool:
        if not self._active or not pkt:
            return False
        ver = pkt[0] >> 4
        if ver == 4:
            return self._match_v4(pkt)
        if ver == 6:
            return self._match_v6(pkt)
        return False

    def _match_v4(self, pkt: bytes) -> bool:
        if len(pkt) < 20:
            return False
        ihl = (pkt[0] & 0xF) * 4
        proto = pkt[9]
        if self.ipv4_local is not None:
            a, m = self.ipv4_local
            if any((pkt[12 + j] ^ a[j]) & m[j] for j in range(4)):
                return False
        if self.ipv4_remote is not None:
            a, m = self.ipv4_remote
            if any((pkt[16 + j] ^ a[j]) & m[j] for j in range(4)):
                return False
        if self.protocol_id is not None and proto != self.protocol_id:
            return False
        if self.type_of_service is not None:
            tos, mask = self.type_of_service
            if (pkt[1] ^ tos) & mask:
                return False
        return self._match_ports(pkt, ihl, proto)

    def _match_v6(self, pkt: bytes) -> bool:
        if len(pkt) < 40:
            return False
        nexthdr = pkt[6]
        if self.ipv6_remote is not None:
            a, m, n = self.ipv6_remote
            if any((pkt[24 + j] ^ a[j]) & m[j] for j in range(n)):
                return False
        if self.ipv6_local is not None:
            a, m, n = self.ipv6_local
            if any((pkt[8 + j] ^ a[j]) & m[j] for j in range(n)):
                return False
        if self.protocol_id is not None and nexthdr != self.protocol_id:
            return False
        if self.flow_label is not None:
            fl = bytes([pkt[1] & 0x0F, pkt[2], pkt[3]])
            if fl != self.flow_label:
                return False
        return self._match_ports(pkt, 40, nexthdr)

    def _match_ports(self, pkt: bytes, off: int, proto: int) -> bool:
        needs_ports = any(x is not None for x in (
            self.single_local_port, self.local_port_range,
            self.single_remote_port, self.remote_port_range))
        if not needs_ports:
            return True
        if proto not in (_UDP, _TCP) or len(pkt) < off + 4:
            return False
        sport = int.from_bytes(pkt[off : off + 2], "big")
        dport = int.from_bytes(pkt[off + 2 : off + 4], "big")
        if self.single_local_port is not None and sport != self.single_local_port:
            return False
        if self.local_port_range is not None and not (
                self.local_port_range[0] <= sport <= self.local_port_range[1]):
            return False
        if self.single_remote_port is not None and dport != self.single_remote_port:
            return False
        if self.remote_port_range is not None and not (
                self.remote_port_range[0] <= dport <= self.remote_port_range[1]):
            return False
        return True


@dataclass
class TftMatcher:
    """Uplink classifier: filters by ascending eval precedence, default
    bearer fallback (gw.cc tft_matcher)."""

    default_lcid: int = 3
    filters: list = field(default_factory=list)

    def add_filter(self, f: TftFilter):
        self.filters.append(f)
        self.filters.sort(key=lambda x: x.eval_precedence)

    def remove_bearer(self, eps_bearer_id: int):
        self.filters = [f for f in self.filters
                        if f.eps_bearer_id != eps_bearer_id]

    def check_match(self, pkt: bytes) -> int:
        """-> LCID of the first matching filter, else the default bearer."""
        for f in self.filters:
            if f.match(pkt):
                return f.lcid
        return self.default_lcid
