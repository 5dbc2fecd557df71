"""BLAKE3 (the public specification, github.com/BLAKE3-team/BLAKE3-specs)
for inputs of any length with a 32-byte output: the hash of the
protocol's Fiat-Shamir transcript."""

from __future__ import annotations

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
W = 0xFFFFFFFF


def _g(s, a, b, c, d, x, y):
    s[a] = (s[a] + s[b] + x) & W
    s[d] = ((s[d] ^ s[a]) >> 16 | (s[d] ^ s[a]) << 16) & W
    s[c] = (s[c] + s[d]) & W
    s[b] = ((s[b] ^ s[c]) >> 12 | (s[b] ^ s[c]) << 20) & W
    s[a] = (s[a] + s[b] + y) & W
    s[d] = ((s[d] ^ s[a]) >> 8 | (s[d] ^ s[a]) << 24) & W
    s[c] = (s[c] + s[d]) & W
    s[b] = ((s[b] ^ s[c]) >> 7 | (s[b] ^ s[c]) << 25) & W


def _compress(cv, block: bytes, counter: int, blen: int, flags: int) -> list:
    m = [int.from_bytes(block[4 * i: 4 * i + 4].ljust(4, b"\0"), "little") for i in range(16)]
    s = list(cv) + list(IV[:4]) + [counter & W, counter >> 32 & W, blen, flags]
    for r in range(7):
        for a, b, c, d, i in ((0, 4, 8, 12, 0), (1, 5, 9, 13, 2), (2, 6, 10, 14, 4),
                              (3, 7, 11, 15, 6), (0, 5, 10, 15, 8), (1, 6, 11, 12, 10),
                              (2, 7, 8, 13, 12), (3, 4, 9, 14, 14)):
            _g(s, a, b, c, d, m[i], m[i + 1])
        m = [m[p] for p in PERM]
    return [s[i] ^ s[i + 8] for i in range(8)] + [s[i + 8] ^ cv[i] for i in range(8)]


def _chunk(data: bytes, counter: int, root: bool) -> list:
    blocks = [data[i: i + 64] for i in range(0, max(len(data), 1), 64)]
    cv = IV
    for j, blk in enumerate(blocks):
        flags = (CHUNK_START if j == 0 else 0) | (CHUNK_END if j == len(blocks) - 1 else 0)
        if root and j == len(blocks) - 1:
            flags |= ROOT
        cv = _compress(cv, blk.ljust(64, b"\0"), counter, len(blk), flags)[:8]
    return cv


def _tree(data: bytes, counter: int, root: bool) -> list:
    chunks = max(1, -(-len(data) // 1024))
    if chunks == 1:
        return _chunk(data, counter, root)
    left = 1 << ((chunks - 1).bit_length() - 1)  # largest power of two below
    lcv = _tree(data[: 1024 * left], counter, False)
    rcv = _tree(data[1024 * left:], counter + left, False)
    block = b"".join(w.to_bytes(4, "little") for w in lcv + rcv)
    return _compress(IV, block, 0, 64, PARENT | (ROOT if root else 0))[:8]


def digest(data: bytes) -> bytes:
    return b"".join(w.to_bytes(4, "little") for w in _tree(bytes(data), 0, True))
