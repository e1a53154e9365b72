"""S1-MME transport: SCTP one-to-one association with TCP fallback.

Reference behavior: lib/src/common/network_utils.cc + srsenb s1ap.cc:33
(SCTP socket toward the MME, PPID 18) and srsepc mme s1ap.cc (listening
SCTP server).  Kernels without SCTP support (common in containers) get a
TCP fallback carrying the same PDUs with a 4-byte length frame — the S1AP
bytes on the wire are identical.

All endpoints are non-blocking and polled from the single-threaded TTI
loop (`poll()` returns zero or more complete PDUs), matching the repo's
no-thread runtime design.
"""

from __future__ import annotations

import errno
import socket
import struct

S1AP_PPID = 18


def sctp_supported() -> bool:
    if not hasattr(socket, "IPPROTO_SCTP"):
        return False
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM,
                          socket.IPPROTO_SCTP)
        s.close()
        return True
    except OSError:
        return False


class _Framed:
    """4-byte-length framed PDU stream over a connected stream socket."""

    def __init__(self, sock: socket.socket, framed: bool):
        self.sock = sock
        self.framed = framed  # False = SCTP (message boundaries preserved)
        self._buf = b""
        self.dead = False
        sock.setblocking(False)

    def send(self, pdu: bytes):
        data = struct.pack("!I", len(pdu)) + pdu if self.framed else pdu
        try:
            self.sock.sendall(data)
        except OSError:
            self.dead = True

    def poll(self) -> list[bytes]:
        out = []
        while True:
            try:
                chunk = self.sock.recv(65536)
            except BlockingIOError:
                break
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                # peer process gone (reset/refused): association is dead,
                # the server prunes it next poll — never crash the MME loop
                self.dead = True
                break
            if not chunk:  # orderly shutdown from the peer
                self.dead = True
                break
            if self.framed:
                self._buf += chunk
            else:
                out.append(chunk)  # SCTP: one recv = one message
        while self.framed and len(self._buf) >= 4:
            n = struct.unpack("!I", self._buf[:4])[0]
            if len(self._buf) < 4 + n:
                break
            out.append(self._buf[4 : 4 + n])
            self._buf = self._buf[4 + n :]
        return out

    def close(self):
        self.sock.close()


class S1Server:
    """MME side: accepts eNB associations (SCTP if available, else TCP)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 force_tcp: bool = False):
        self.sctp = sctp_supported() and not force_tcp
        proto = socket.IPPROTO_SCTP if self.sctp else 0
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM, proto)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lsock.bind((host, port))
        self.lsock.listen(8)
        self.lsock.setblocking(False)
        self.port = self.lsock.getsockname()[1]
        self.assocs: list[_Framed] = []

    def poll(self) -> list[tuple[_Framed, bytes]]:
        """Accept new associations and drain PDUs from every eNB."""
        while True:
            try:
                conn, _ = self.lsock.accept()
            except (BlockingIOError, OSError):
                break
            self.assocs.append(_Framed(conn, framed=not self.sctp))
        out = []
        for a in self.assocs:
            for pdu in a.poll():
                out.append((a, pdu))
        for a in [a for a in self.assocs if a.dead]:
            a.close()
            self.assocs.remove(a)
        return out

    def close(self):
        for a in self.assocs:
            a.close()
        self.lsock.close()


class S1Client(_Framed):
    """eNB side: one association toward the MME."""

    def __init__(self, host: str = "127.0.0.1", port: int = 36412,
                 force_tcp: bool = False):
        use_sctp = sctp_supported() and not force_tcp
        proto = socket.IPPROTO_SCTP if use_sctp else 0
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM, proto)
        sock.connect((host, port))
        super().__init__(sock, framed=not use_sctp)


class GtpuSocket:
    """GTP-U/UDP endpoint (29.281 port 2152; srsenb gtpu.cc:53-95,
    srsepc spgw/gtpu.cc:105)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.setblocking(False)
        self.addr = self.sock.getsockname()

    def send(self, raw: bytes, addr):
        self.sock.sendto(raw, addr)

    def poll(self) -> list[tuple[bytes, tuple]]:
        out = []
        while True:
            try:
                data, addr = self.sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            out.append((data, addr))
        return out

    def close(self):
        self.sock.close()
