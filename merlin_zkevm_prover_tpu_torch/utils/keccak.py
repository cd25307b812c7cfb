"""Compact Keccak-f[1600] + Ethereum keccak-256 (reference src/XKCP/
Keccak-more-compact.cpp role).  Pure python; the gate-level Keccak trace
for the proving pipeline lives in executor/sm/keccak_f.py."""

from __future__ import annotations

from typing import List

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M


def keccak_f(state: List[int]) -> List[int]:
    """One permutation of the 5x5 uint64 state (flat list of 25)."""
    a = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTATIONS[x][y])
        # chi
        a = [
            [b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
             for y in range(5)]
            for x in range(5)
        ]
        # iota
        a[0][0] ^= rc
    return [a[x][y] for y in range(5) for x in range(5)]


def _keccak(data: bytes, rate_bytes: int, pad_byte: int, out_len: int) -> bytes:
    state = [0] * 25
    # absorb
    msg = bytearray(data)
    msg.append(pad_byte)
    while len(msg) % rate_bytes != 0:
        msg.append(0)
    msg[-1] |= 0x80
    for off in range(0, len(msg), rate_bytes):
        block = msg[off:off + rate_bytes]
        for i in range(rate_bytes // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f(state)
    # squeeze
    out = b""
    while len(out) < out_len:
        out += b"".join(
            state[i].to_bytes(8, "little") for i in range(rate_bytes // 8)
        )
        if len(out) < out_len:
            state = keccak_f(state)
    return out[:out_len]


def keccak256(data: bytes) -> bytes:
    """Ethereum keccak-256 (pad 0x01)."""
    return _keccak(data, 136, 0x01, 32)


def sha3_256(data: bytes) -> bytes:
    """NIST SHA3-256 (pad 0x06)."""
    return _keccak(data, 136, 0x06, 32)
