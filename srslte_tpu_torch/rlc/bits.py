"""Bit-level pack/unpack helpers for RLC headers (36.322 §6.2)."""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def put(self, value: int, width: int):
        for i in range(width - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def to_bytes(self) -> bytes:
        bits = self._bits + [0] * (-len(self._bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)

    def __len__(self):
        return len(self._bits)


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self.pos = 0

    def get(self, width: int) -> int:
        v = 0
        for _ in range(width):
            byte = self._data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def rest(self) -> bytes:
        assert self.pos % 8 == 0
        return self._data[self.pos >> 3 :]
