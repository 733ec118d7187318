"""BLS12-381 curve groups G1 (keys, 48B compressed) and G2 (signatures, 96B).

Matches the reference suite layout: keys on G1, signatures on G2
(drand key/curve.go:22-31) and the zcash/kyber compressed point
serialization (48-byte G1 pubkeys, 96-byte G2 sigs —
drand README.md:204, deploy/latest/group.toml).

Jacobian coordinates; a = 0 curves (y^2 = x^3 + 4 and y^2 = x^3 + 4(1+u)).
Cofactors are computed from the BLS parameter x at import (standard BLS12
polynomials), never hard-coded.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Iterable

from .fields import (
    P,
    R,
    X_BLS,
    FP_BYTES,
    Fp,
    Fp2,
)

# Cofactors from the BLS12 family polynomials (verified at import below).
H1 = (X_BLS - 1) ** 2 // 3
_h2_num = (
    X_BLS**8 - 4 * X_BLS**7 + 5 * X_BLS**6 - 4 * X_BLS**4
    + 6 * X_BLS**3 - 4 * X_BLS**2 - 4 * X_BLS + 13
)
assert _h2_num % 9 == 0
H2 = _h2_num // 9
assert (X_BLS - 1) ** 2 % 3 == 0


class _JacobianPoint:
    """Generic Jacobian point on y^2 = x^3 + B over FIELD (a = 0).

    Subclasses set FIELD, B, GENERATOR_AFFINE, COFACTOR, COMPRESSED_SIZE.
    Point at infinity is represented by Z = 0.
    """

    __slots__ = ("X", "Y", "Z")

    FIELD = None  # field class (Fp or Fp2)
    B = None  # curve coefficient
    COFACTOR = 1
    COMPRESSED_SIZE = 0

    def __init__(self, X, Y, Z):
        self.X = X
        self.Y = Y
        self.Z = Z

    # -- constructors -------------------------------------------------------
    @classmethod
    def infinity(cls):
        F = cls.FIELD
        return cls(F.one(), F.one(), F.zero())

    @classmethod
    def from_affine(cls, x, y):
        return cls(x, y, cls.FIELD.one())

    @classmethod
    def generator(cls):
        return cls.from_affine(*cls.GENERATOR_AFFINE)

    # -- predicates ---------------------------------------------------------
    def is_infinity(self) -> bool:
        return self.Z.is_zero()

    def __eq__(self, other) -> bool:
        if not isinstance(other, type(self)):
            return NotImplemented
        if self.is_infinity() or other.is_infinity():
            return self.is_infinity() and other.is_infinity()
        # X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3
        z1s = self.Z.square()
        z2s = other.Z.square()
        if self.X * z2s != other.X * z1s:
            return False
        return self.Y * (z2s * other.Z) == other.Y * (z1s * self.Z)

    def __hash__(self):
        if self.is_infinity():
            return hash((type(self).__name__, "inf"))
        x, y = self.to_affine()
        return hash((type(self).__name__, repr(x), repr(y)))

    def __repr__(self):
        if self.is_infinity():
            return f"{type(self).__name__}(infinity)"
        x, y = self.to_affine()
        return f"{type(self).__name__}({x!r}, {y!r})"

    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        x, y = self.to_affine()
        return y.square() == x.square() * x + self.B

    def in_subgroup(self) -> bool:
        """Order-r check. O(log r) doublings; used on deserialization."""
        return self.mul(R).is_infinity()

    # -- group law ----------------------------------------------------------
    def to_affine(self):
        if self.is_infinity():
            raise ValueError("point at infinity has no affine coords")
        zinv = self.Z.inverse()
        zinv2 = zinv.square()
        return self.X * zinv2, self.Y * (zinv2 * zinv)

    @classmethod
    def batch_to_affine(cls, pts):
        """Affine coords for many points with ONE field inversion
        (Montgomery's simultaneous-inversion trick) — per-point
        ``to_affine`` pays a full exponentiation-based inverse each,
        which dominates host packing of large device batches.
        Raises on any point at infinity, like :meth:`to_affine`."""
        zs = []
        for p in pts:
            if p.is_infinity():
                raise ValueError("point at infinity has no affine coords")
            zs.append(p.Z)
        if not zs:
            return []
        prefix = [zs[0]]
        for z in zs[1:]:
            prefix.append(prefix[-1] * z)
        inv = prefix[-1].inverse()
        out = [None] * len(pts)
        for i in range(len(pts) - 1, -1, -1):
            zinv = inv * prefix[i - 1] if i else inv
            inv = inv * zs[i]
            zinv2 = zinv.square()
            out[i] = (pts[i].X * zinv2, pts[i].Y * (zinv2 * zinv))
        return out

    def double(self):
        if self.is_infinity():
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1.square()
        Bv = Y1.square()
        C = Bv.square()
        D = ((X1 + Bv).square() - A - C).mul_scalar(2)
        E = A.mul_scalar(3)
        F = E.square()
        X3 = F - D.mul_scalar(2)
        Y3 = E * (D - X3) - C.mul_scalar(8)
        Z3 = (Y1 * Z1).mul_scalar(2)
        return type(self)(X3, Y3, Z3)

    def __add__(self, other):
        if self.is_infinity():
            return other
        if other.is_infinity():
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = other.X, other.Y, other.Z
        Z1Z1 = Z1.square()
        Z2Z2 = Z2.square()
        U1 = X1 * Z2Z2
        U2 = X2 * Z1Z1
        S1 = Y1 * Z2 * Z2Z2
        S2 = Y2 * Z1 * Z1Z1
        H = U2 - U1
        if H.is_zero():
            if S1 == S2:
                return self.double()
            return self.infinity()
        I = H.square().mul_scalar(4)
        J = H * I
        r = (S2 - S1).mul_scalar(2)
        V = U1 * I
        X3 = r.square() - J - V.mul_scalar(2)
        Y3 = r * (V - X3) - (S1 * J).mul_scalar(2)
        Z3 = ((Z1 + Z2).square() - Z1Z1 - Z2Z2) * H
        return type(self)(X3, Y3, Z3)

    def __neg__(self):
        return type(self)(self.X, -self.Y, self.Z)

    def __sub__(self, other):
        return self + (-other)

    def mul(self, k: int):
        """Scalar multiplication (double-and-add, MSB first)."""
        k = int(k)
        if k < 0:
            return (-self).mul(-k)
        result = self.infinity()
        if k == 0 or self.is_infinity():
            return result
        for bit in bin(k)[2:]:
            result = result.double()
            if bit == "1":
                result = result + self
        return result

    def clear_cofactor(self):
        return self.mul(self.COFACTOR)

    @classmethod
    def msm(cls, scalars: Iterable[int], points: Iterable["_JacobianPoint"]):
        """Multi-scalar multiplication (naive host fallback; the TPU engine
        provides the batched Pippenger version)."""
        acc = cls.infinity()
        for s, pt in zip(scalars, points):
            acc = acc + pt.mul(s)
        return acc

    # -- serialization (zcash format) ---------------------------------------
    def _y_is_lexicographically_largest(self) -> bool:
        raise NotImplementedError

    def to_bytes(self) -> bytes:
        """Compressed serialization: x with 3 flag bits in the top byte."""
        size = self.COMPRESSED_SIZE
        if self.is_infinity():
            out = bytearray(size)
            out[0] = 0xC0
            return bytes(out)
        x, _ = self.to_affine()
        out = bytearray(x.to_bytes())
        out[0] |= 0x80  # compression flag
        if self._y_is_lexicographically_largest():
            out[0] |= 0x20  # sort flag
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes, subgroup_check: bool = True):
        size = cls.COMPRESSED_SIZE
        if len(data) != size:
            raise ValueError(f"expected {size} bytes, got {len(data)}")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed encoding not supported")
        if flags & 0x40:  # infinity
            if any(data[1:]) or flags != 0xC0:
                raise ValueError("malformed infinity encoding")
            return cls.infinity()
        sort_flag = bool(flags & 0x20)
        xb = bytearray(data)
        xb[0] &= 0x1F
        x = cls.FIELD.from_bytes(bytes(xb))
        y2 = x.square() * x + cls.B
        y = y2.sqrt()
        if y is None:
            raise ValueError("x-coordinate not on curve")
        pt = cls.from_affine(x, y)
        if pt._y_is_lexicographically_largest() != sort_flag:
            pt = -pt
        if not pt.is_on_curve():
            raise ValueError("point not on curve")
        if subgroup_check and not pt.in_subgroup():
            raise ValueError("point not in the r-order subgroup")
        return pt

    def hash(self) -> bytes:
        """blake2b-256 of the compressed encoding (used in group hashing,
        mirroring drand key/group.go:24)."""
        return hashlib.blake2b(self.to_bytes(), digest_size=32).digest()


class PointG1(_JacobianPoint):
    """G1: y^2 = x^3 + 4 over Fp. Public keys live here (48-byte compressed)."""

    FIELD = Fp
    B = Fp(4)
    COFACTOR = H1
    COMPRESSED_SIZE = FP_BYTES
    GENERATOR_AFFINE = (
        Fp(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
        Fp(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
    )

    def _y_is_lexicographically_largest(self) -> bool:
        _, y = self.to_affine()
        return y.v > (P - 1) // 2


class PointG2(_JacobianPoint):
    """G2: y^2 = x^3 + 4(1+u) over Fp2. Signatures live here (96B compressed)."""

    FIELD = Fp2
    B = Fp2(4, 4)
    COFACTOR = H2
    COMPRESSED_SIZE = 2 * FP_BYTES
    GENERATOR_AFFINE = (
        Fp2(
            0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
            0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
        ),
        Fp2(
            0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
            0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
        ),
    )

    def _y_is_lexicographically_largest(self) -> bool:
        _, y = self.to_affine()
        neg = -y
        return (y.c1, y.c0) > (neg.c1, neg.c0)


# ---------------------------------------------------------------------------
# Fixed-base comb for G1 generator multiples (promoted from crypto/timelock,
# which keeps aliases): every g·s share-side check in the DKG and both
# timelock hot sites multiply the SAME base, so an 8-bit windowed table
# (32 windows × 255 multiples, built lazily once) turns a 255-bit
# double-and-add ladder into ≤ 32 additions per scalar.
# ---------------------------------------------------------------------------

_COMB_WINDOW = 8
_G1_COMB_TABLE: list[list["PointG1"]] | None = None
_G1_COMB_LOCK = threading.Lock()


def _g1_comb_table() -> list[list["PointG1"]]:
    global _G1_COMB_TABLE
    if _G1_COMB_TABLE is None:
        with _G1_COMB_LOCK:
            if _G1_COMB_TABLE is None:
                table = []
                base = PointG1.generator()
                for _ in range(-(-255 // _COMB_WINDOW)):
                    row = [PointG1.infinity(), base]
                    for _d in range(2, 1 << _COMB_WINDOW):
                        row.append(row[-1] + base)
                    table.append(row)
                    for _s in range(_COMB_WINDOW):
                        base = base.double()
                _G1_COMB_TABLE = table
    return _G1_COMB_TABLE


def g1_comb_mul(k: int) -> "PointG1":
    """k * G1 via the fixed-base comb (equal to generator().mul(k))."""
    k %= R
    if k == 0:
        return PointG1.infinity()
    table = _g1_comb_table()
    acc = PointG1.infinity()
    i = 0
    while k:
        d = k & ((1 << _COMB_WINDOW) - 1)
        if d:
            acc = acc + table[i][d]
        k >>= _COMB_WINDOW
        i += 1
    return acc


def _import_self_test() -> None:
    g1 = PointG1.generator()
    g2 = PointG2.generator()
    assert g1.is_on_curve(), "G1 generator off curve"
    assert g2.is_on_curve(), "G2 generator off curve"
    assert g1.mul(R).is_infinity(), "G1 generator order != r"
    assert g2.mul(R).is_infinity(), "G2 generator order != r"
    # serialization round-trips
    assert PointG1.from_bytes(g1.to_bytes()) == g1
    assert PointG2.from_bytes(g2.to_bytes()) == g2


_import_self_test()
