"""Proof container and 944-bit serialization.

A copy of dvpari_tpu/protocol/proof.py (pure python).

(reference: Proof, src/proving.rs:28-50 and to_bits/from_bits
:691-770; FrBits, src/curve.rs:26-60)
"""

from __future__ import annotations

from dataclasses import dataclass

from dvpari_tpu_torch.ops import fr


def fr_to_bits(value: int) -> "list[bool]":
    """232 little-endian bits of a canonical Fr element
    (reference: FrBits::from_fr, src/curve.rs:30-40)."""
    v = int(value) % fr.P
    return [bool((v >> i) & 1) for i in range(232)]


def fr_from_bits(bits: "list[bool]") -> "tuple[int, bool]":
    """Bits -> (Fr, is_valid); invalid if >= p
    (reference: FrBits::to_fr, src/curve.rs:43-59)."""
    v = 0
    for i, b in enumerate(bits):
        if b:
            v |= 1 << i
    return v % fr.P, v < fr.P


def _bytes_to_bits_le(data: bytes) -> "list[bool]":
    return [bool((byte >> i) & 1) for byte in data for i in range(8)]


def _bits_to_bytes_le(bits: "list[bool]") -> bytes:
    out = bytearray(len(bits) // 8)
    for j in range(len(out)):
        v = 0
        for i in range(8):
            if bits[8 * j + i]:
                v |= 1 << i
        out[j] = v
    return bytes(out)


@dataclass
class Proof:
    """commit_p / kzg_k: 30-byte compressed points; a0 / b0: Fr ints."""

    commit_p: bytes
    kzg_k: bytes
    a0: int
    b0: int
    # scalar-encoding validity (reference tracks this via FrBits::to_fr and
    # ANDs it into the verdict, src/srs.rs:414-425)
    a0_valid: bool = True
    b0_valid: bool = True

    def to_bits(self) -> "list[bool]":
        """944 bits: 240 + 240 + 232 + 232 (reference: src/proving.rs:691-718)."""
        bits = _bytes_to_bits_le(self.commit_p)
        bits += _bytes_to_bits_le(self.kzg_k)
        bits += fr_to_bits(self.a0)
        bits += fr_to_bits(self.b0)
        assert len(bits) == 944
        return bits

    @classmethod
    def from_bits(cls, bits: "list[bool]") -> "Proof":
        assert len(bits) == 944
        commit_p = _bits_to_bytes_le(bits[0:240])
        kzg_k = _bits_to_bytes_le(bits[240:480])
        a0, a0_valid = fr_from_bits(bits[480:712])
        b0, b0_valid = fr_from_bits(bits[712:944])
        return cls(commit_p, kzg_k, a0, b0, a0_valid, b0_valid)
