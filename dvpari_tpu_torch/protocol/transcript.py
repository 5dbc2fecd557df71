"""Fiat-Shamir transcript: blake3 two-level hash tree -> 224-bit challenge.

A copy of dvpari_tpu/protocol/transcript.py (pure python).

Bit-exact mirror of the reference transcript
(reference: Transcript, src/proving.rs:72-198):

- srs_hash / circuit_info_hash: blake3 of an EMPTY buffer (the reference
  comments out the expensive hashing because these are compile-time
  constants; we reproduce the exact behavior, src/proving.rs:88-134).
- witness_commitment_hash: blake3 of concatenated 30-byte points.
- public_input_hash: blake3 of 29-byte little-endian scalars.
- output: root = H(H(srs || circuit) || H(commit || pub)); top 4 bytes
  zeroed (224-bit mask); little-endian into Fr.
"""

from __future__ import annotations

from dvpari_tpu_torch.ops import fr
from dvpari_tpu_torch.utils.blake3 import blake3_digest


class Transcript:
    def __init__(self):
        self._srs = None
        self._circuit = None
        self._commit = None
        self._pub = None

    def srs_hash(self, _srs=None) -> None:
        # compile-time constant in practice (reference: src/proving.rs:88-107)
        self._srs = blake3_digest(b"")

    def circuit_info_hash(self, _inst=None) -> None:
        # compile-time constant in practice (reference: src/proving.rs:111-134)
        self._circuit = blake3_digest(b"")

    def witness_commitment_hash(self, commitments: "list[bytes]") -> None:
        buf = b"".join(commitments)
        assert all(len(c) == 30 for c in commitments)
        self._commit = blake3_digest(buf)

    def public_input_hash(self, public_inputs: "list[int]") -> None:
        buf = b"".join(
            (int(x) % fr.P).to_bytes(232 // 8, "little") for x in public_inputs
        )
        self._pub = blake3_digest(buf)

    def output(self) -> int:
        assert None not in (self._srs, self._circuit, self._commit, self._pub)
        compiletime = blake3_digest(self._srs + self._circuit)
        runtime = blake3_digest(self._commit + self._pub)
        root = bytearray(blake3_digest(compiletime + runtime))
        root[28:] = b"\x00\x00\x00\x00"  # mask top 4 bytes -> 224 bits
        return int.from_bytes(bytes(root), "little")
