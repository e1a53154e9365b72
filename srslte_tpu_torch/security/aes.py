"""AES-128 block cipher + CTR mode + CMAC (pure Python, host-side).

Used by EEA2/EIA2 (33.401) and Milenage (35.206).  The stack ciphers control
plane PDUs on the host; data-plane bulk ciphering at line rate would move to
a batched device kernel in a later round.
"""

from __future__ import annotations

_SBOX = None


def _init_tables():
    global _SBOX
    if _SBOX is not None:
        return
    # generate the S-box algebraically (multiplicative inverse + affine map)
    p, q = 1, 1
    sbox = [0] * 256
    while True:
        # p *= 3 in GF(2^8)
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        # q /= 3
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        x = q ^ ((q << 1) | (q >> 7)) ^ ((q << 2) | (q >> 6)) \
            ^ ((q << 3) | (q >> 5)) ^ ((q << 4) | (q >> 4))
        sbox[p] = (x ^ 0x63) & 0xFF
        if p == 1:
            break
    sbox[0] = 0x63
    _SBOX = sbox


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1


def _expand_key(key: bytes) -> list:
    _init_tables()
    rcon = 1
    w = [list(key[i : i + 4]) for i in range(0, 16, 4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r : 4 * r + 4], []) for r in range(11)]


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    """One 16-byte ECB encryption."""
    _init_tables()
    rk = _expand_key(key)
    s = [block[r + 4 * c] for c in range(4) for r in range(4)]  # column-major in
    # state as 4x4: s[r][c]; keep flat col-major: idx = r + 4c
    st = list(block)
    st = [b ^ k for b, k in zip(st, rk[0])]
    for rnd in range(1, 11):
        st = [_SBOX[b] for b in st]
        # ShiftRows on column-major byte order (st[i]: i = 4*c + r? we use
        # the standard byte order: st[4c+r] is row r of column c)
        ns = list(st)
        for r in range(1, 4):
            for c in range(4):
                ns[4 * c + r] = st[4 * ((c + r) % 4) + r]
        st = ns
        if rnd < 10:
            ns = []
            for c in range(4):
                a = st[4 * c : 4 * c + 4]
                ns.extend([
                    _xtime(a[0]) ^ (_xtime(a[1]) ^ a[1]) ^ a[2] ^ a[3],
                    a[0] ^ _xtime(a[1]) ^ (_xtime(a[2]) ^ a[2]) ^ a[3],
                    a[0] ^ a[1] ^ _xtime(a[2]) ^ (_xtime(a[3]) ^ a[3]),
                    (_xtime(a[0]) ^ a[0]) ^ a[1] ^ a[2] ^ _xtime(a[3]),
                ])
            st = ns
        st = [b ^ k for b, k in zip(st, rk[rnd])]
    return bytes(st)


def aes128_ctr(key: bytes, counter0: bytes, data: bytes) -> bytes:
    """CTR keystream XOR (counter0 = first 16-byte counter block)."""
    out = bytearray()
    ctr = int.from_bytes(counter0, "big")
    for i in range(0, len(data), 16):
        ks = aes128_encrypt_block(key, ctr.to_bytes(16, "big"))
        chunk = data[i : i + 16]
        out.extend(b ^ k for b, k in zip(chunk, ks))
        ctr = (ctr + 1) % (1 << 128)
    return bytes(out)


def _cmac_subkeys(key: bytes):
    def dbl(b: bytes) -> bytes:
        v = int.from_bytes(b, "big") << 1
        if b[0] & 0x80:
            v ^= 0x87
        return (v & ((1 << 128) - 1)).to_bytes(16, "big")

    l = aes128_encrypt_block(key, bytes(16))
    k1 = dbl(l)
    k2 = dbl(k1)
    return k1, k2


def aes128_cmac(key: bytes, msg: bytes) -> bytes:
    """RFC 4493 CMAC (full-byte messages)."""
    k1, k2 = _cmac_subkeys(key)
    n = max(1, -(-len(msg) // 16))
    complete = len(msg) % 16 == 0 and len(msg) > 0
    x = bytes(16)
    for i in range(n - 1):
        blk = msg[16 * i : 16 * i + 16]
        x = aes128_encrypt_block(key, bytes(a ^ b for a, b in zip(x, blk)))
    last = msg[16 * (n - 1) :]
    if complete:
        last = bytes(a ^ b for a, b in zip(last, k1))
    else:
        last = last + b"\x80" + bytes(15 - len(last))
        last = bytes(a ^ b for a, b in zip(last, k2))
    return aes128_encrypt_block(key, bytes(a ^ b for a, b in zip(x, last)))
