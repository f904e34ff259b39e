"""Fiat-Shamir transcript — blake2b, halo2-shaped framing
(SURVEY.md section 2.2, "Transcript"; halo2-axiom's Blake2bWrite/Blake2bRead).

Framing follows halo2's Blake2bTranscript conventions exactly:
- state: blake2b with 64-byte digest, personal tag b"Halo2-Transcript"
- absorbing a G1 point: prefix 0x01 then x, y coordinates as 32-byte LE
  field elements (infinity is an error, as in halo2)
- absorbing a scalar: prefix 0x02 then 32-byte LE
- squeezing a challenge: update state with prefix 0x00, then finalize a
  CLONE of the state (the running state is kept and continues absorbing —
  halo2 semantics); challenge = 64-byte digest LE mod r
  (Challenge255 / from_uniform_bytes)
- the PROOF STREAM encodes points in halo2curves' 32-byte COMPRESSED form
  (not the 64-byte uncompressed x||y):
    * identity -> 32 zero bytes
    * else    -> x as 32-byte LE with bit 7 of byte 31 set to (y & 1)
  (BN254 Fq is 254 bits so the two top bits of byte 31 are spare);
  scalars are 32-byte LE.

Note on reference parity: the reference's proofs come from halo2-axiom's
Rust implementation; with no Rust toolchain in this environment, byte-level
cross-validation is not runnable here, so the framing is pinned by fixture
transcripts in tests/test_transcript_fixtures.py (fixed seed -> expected
bytes) and kept prover/verifier replay bit-exact.

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/plonk/transcript.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import hashlib

from ..ec.host import Point
from ..ff.host import FQ_MOD, FR_MOD

BLAKE2B_PREFIX_CHALLENGE = b"\x00"
BLAKE2B_PREFIX_POINT = b"\x01"
BLAKE2B_PREFIX_SCALAR = b"\x02"

_SIGN_BIT = 0x80  # bit 7 of byte 31 carries the parity of y


def _fe_bytes(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def point_to_bytes(p: Point) -> bytes:
    """halo2curves compressed encoding: 32-byte LE x with y-parity flag."""
    if p is None:
        return bytes(32)
    buf = bytearray(_fe_bytes(p[0]))
    if p[1] & 1:
        buf[31] |= _SIGN_BIT
    return bytes(buf)


def point_from_bytes(raw: bytes) -> Point:
    """Decompress; raises ValueError on any invalid encoding."""
    if len(raw) != 32:
        raise ValueError("bad point length")
    if raw == bytes(32):
        return None
    buf = bytearray(raw)
    sign = (buf[31] & _SIGN_BIT) >> 7
    buf[31] &= ~_SIGN_BIT & 0xFF
    x = int.from_bytes(bytes(buf), "little")
    if x >= FQ_MOD:
        raise ValueError("x coordinate out of range")
    rhs = (pow(x, 3, FQ_MOD) + 3) % FQ_MOD
    y = pow(rhs, (FQ_MOD + 1) // 4, FQ_MOD)  # q = 3 mod 4
    if y * y % FQ_MOD != rhs:
        raise ValueError("x not on curve")
    if (y & 1) != sign:
        y = FQ_MOD - y
    return (x, y)


class _State:
    def __init__(self) -> None:
        self._h = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")

    def common_point(self, p: Point) -> None:
        if p is None:
            raise ValueError("cannot absorb the point at infinity")
        self._h.update(BLAKE2B_PREFIX_POINT)
        self._h.update(_fe_bytes(p[0]))
        self._h.update(_fe_bytes(p[1]))

    def common_scalar(self, s: int) -> None:
        self._h.update(BLAKE2B_PREFIX_SCALAR)
        self._h.update(_fe_bytes(s % FR_MOD))

    def squeeze_challenge(self) -> int:
        # halo2: absorb the prefix, finalize a CLONE, keep the state running.
        self._h.update(BLAKE2B_PREFIX_CHALLENGE)
        digest = self._h.copy().digest()
        return int.from_bytes(digest, "little") % FR_MOD


class TranscriptWriter:
    """Prover side: absorbs commitments/evals, emits the proof byte stream."""

    def __init__(self) -> None:
        self._st = _State()
        self._proof = bytearray()

    # -- absorb only (no proof bytes): e.g. vk hash / instance commitments --

    def common_point(self, p: Point) -> None:
        self._st.common_point(p)

    def common_scalar(self, s: int) -> None:
        self._st.common_scalar(s)

    # -- write: absorb + append to proof ------------------------------------

    def write_point(self, p: Point) -> None:
        self.common_point(p)
        self._proof += point_to_bytes(p)

    def write_scalar(self, s: int) -> None:
        self.common_scalar(s)
        self._proof += _fe_bytes(s % FR_MOD)

    def squeeze_challenge(self) -> int:
        return self._st.squeeze_challenge()

    def finalize(self) -> bytes:
        return bytes(self._proof)


class TranscriptReader:
    """Verifier side: replays the byte stream, re-deriving identical challenges."""

    def __init__(self, proof: bytes) -> None:
        self._st = _State()
        self._buf = memoryview(proof)
        self._pos = 0

    def common_point(self, p: Point) -> None:
        self._st.common_point(p)

    def common_scalar(self, s: int) -> None:
        self._st.common_scalar(s)

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise ValueError("transcript exhausted")
        out = bytes(self._buf[self._pos : self._pos + n])
        self._pos += n
        return out

    def read_point(self) -> Point:
        p = point_from_bytes(self._take(32))
        if p is None:
            raise ValueError("unexpected point at infinity in proof")
        self.common_point(p)
        return p

    def read_scalar(self) -> int:
        s = int.from_bytes(self._take(32), "little")
        if s >= FR_MOD:
            raise ValueError("scalar out of range")
        self.common_scalar(s)
        return s

    def squeeze_challenge(self) -> int:
        return self._st.squeeze_challenge()

    def assert_consumed(self) -> None:
        if self._pos != len(self._buf):
            raise ValueError("trailing bytes in proof")
