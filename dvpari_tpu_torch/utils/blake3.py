"""Pure-Python BLAKE3 (hashing side of the Fiat-Shamir transcript).

A copy of dvpari_tpu/utils/blake3.py: the port imports nothing from the
JAX package.

The reference uses the `blake3` Rust crate for transcript hashing
(reference: src/proving.rs:72-198) and SP1 public-input hashing
(reference: src/gnark_r1cs.rs:214-229).  All runtime inputs are tiny
(<= a few KB), so a host-side implementation is the right design for the
TPU build: hashing never belongs on the MXU/VPU, and keeping it on the
host keeps the jitted prover pipeline free of byte-level control flow.

This is a from-scratch implementation of the public BLAKE3 spec,
validated against the official test vectors in tests/test_blake3.py.
"""

from __future__ import annotations

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024

_MASK32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK32


def _g(state: list[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & _MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state: list[int], m: list[int]) -> None:
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def _compress(
    cv: tuple[int, ...],
    block_words: list[int],
    counter: int,
    block_len: int,
    flags: int,
) -> list[int]:
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK32, (counter >> 32) & _MASK32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(state, m)
        if r != 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    return [
        state[i] ^ state[i + 8] if i < 8 else state[i] ^ cv[i - 8]
        for i in range(16)
    ]


def _words_from_block(block: bytes) -> list[int]:
    block = block + b"\x00" * (BLOCK_LEN - len(block))
    return [int.from_bytes(block[4 * i : 4 * i + 4], "little") for i in range(16)]


def _chunk_output(chunk: bytes, chunk_counter: int):
    """Compress a <=1024-byte chunk; return (cv, last_block_state_inputs).

    Returns the inputs of the *final* compression so the caller can re-run
    it with the ROOT flag when this chunk is the whole tree.
    """
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, max(len(chunk), 1), BLOCK_LEN)]
    cv = IV
    for i, block in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
        words = _words_from_block(block)
        if i == len(blocks) - 1:
            return cv, (words, chunk_counter, len(block), flags)
        cv = tuple(_compress(cv, words, chunk_counter, len(block), flags)[:8])
    raise AssertionError("unreachable")


def _left_len(total_chunks: int) -> int:
    # Left subtree gets the largest power of two strictly less than total.
    p = 1
    while p * 2 < total_chunks:
        p *= 2
    return p


def _subtree_cv(data: bytes, chunk_counter: int, is_root: bool):
    """Return chaining value of a subtree; if is_root, return the digest words."""
    n_chunks = (len(data) + CHUNK_LEN - 1) // CHUNK_LEN
    if len(data) == 0:
        n_chunks = 1
    if n_chunks == 1:
        cv, (words, counter, blen, flags) = _chunk_output(data, chunk_counter)
        if is_root:
            return _compress(cv, words, counter, blen, flags | ROOT)
        return tuple(_compress(cv, words, counter, blen, flags)[:8])
    split = _left_len(n_chunks) * CHUNK_LEN
    left = _subtree_cv(data[:split], chunk_counter, False)
    right = _subtree_cv(data[split:], chunk_counter + split // CHUNK_LEN, False)
    block = list(left) + list(right)
    if is_root:
        return _compress(IV, block, 0, BLOCK_LEN, PARENT | ROOT)
    return tuple(_compress(IV, block, 0, BLOCK_LEN, PARENT)[:8])


def blake3_digest(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 hash of `data` (default 32-byte output, matching blake3::hash)."""
    if out_len > 64:
        raise NotImplementedError("extended XOF output not needed by the protocol")
    words = _subtree_cv(bytes(data), 0, True)
    out = b"".join(w.to_bytes(4, "little") for w in words)
    return out[:out_len]
