"""The ψ (untwist-Frobenius-twist) endomorphism on G2: Scott's subgroup
check and the GLS 4-D scalar split of the recovery MSM.

Own copy of the G2 parts of the JAX package's ``crypto/endo.py`` (the G1
GLV parts and the Budroni-Pintore cofactor clearing are left out: the
port does not use them yet).

ψ acts on affine twist coordinates as ψ(x, y) = (c_x·x̄, c_y·ȳ). The
constants are solved from the port's own curve arithmetic — ψ acts as
multiplication by the BLS parameter x on the r-order subgroup — and
validated at import (``_validate``), with explicit raises that survive
``python -O``.

- subgroup check: ψ(Q) == [x]Q, one 64-bit chain instead of a 255-bit
  one (same accept set as ``PointG2.in_subgroup``);
- GLS4: with M = −x, r < M⁴, so c mod r has four base-M digits d_k <
  2^64 and c·P = Σ d_k·[M^k]P with [M^k]P = ±ψ^k(P): a 255-step ladder
  becomes four 64-step ladders on (P, −ψP, ψ²P, −ψ³P).
"""

from __future__ import annotations

from .curves import PointG2
from .fields import Fp2, R, X_BLS


def _solve_constants() -> tuple[Fp2, Fp2]:
    """c_x, c_y from ψ(G) = [x mod r]G on two independent subgroup points
    (the map must be pointwise-consistent)."""
    x_mod_r = X_BLS % R
    sols = []
    for seed in (1, 0xA5A5):
        g = PointG2.generator().mul(seed)
        gx, gy = g.to_affine()
        hx, hy = g.mul(x_mod_r).to_affine()
        sols.append((hx * gx.conjugate().inverse(),
                     hy * gy.conjugate().inverse()))
    if sols[0] != sols[1]:
        raise AssertionError("psi constants are not pointwise-consistent")
    return sols[0]


PSI_CX, PSI_CY = _solve_constants()
# ψ²: conj∘conj = id, so plain per-coordinate multipliers
PSI2_CX = PSI_CX * PSI_CX.conjugate()
PSI2_CY = PSI_CY * PSI_CY.conjugate()
# ψ³ = ψ∘ψ²
PSI3_CX = PSI_CX * PSI2_CX.conjugate()
PSI3_CY = PSI_CY * PSI2_CY.conjugate()

GLS4_M = -X_BLS
GLS4_DIGIT_BITS = GLS4_M.bit_length()  # 64
if R >= GLS4_M ** 4:
    raise AssertionError("GLS4: r >= M^4 — four base-M digits insufficient")


def gls4_decompose(c: int) -> tuple[int, int, int, int]:
    """Base-M digits (d0, d1, d2, d3) of ``c mod r``, each < 2^64, with
    c·P = d0·P + d1·[M]P + d2·[M²]P + d3·[M³]P on the r-order subgroup."""
    c %= R
    d0 = c % GLS4_M
    c //= GLS4_M
    d1 = c % GLS4_M
    c //= GLS4_M
    d2 = c % GLS4_M
    return d0, d1, d2, c // GLS4_M


def gls4_points_from_affine(x: Fp2, y: Fp2) -> list[PointG2]:
    """The GLS basis [P, [M]P, [M²]P, [M³]P] = [P, −ψP, ψ²P, −ψ³P] from
    affine coordinates: six Fp2 products, no inversion, every point with
    Z = 1. P must lie in the r-order subgroup."""
    xb, yb = x.conjugate(), y.conjugate()
    one = Fp2.one()
    return [PointG2(x, y, one),
            PointG2(PSI_CX * xb, -(PSI_CY * yb), one),
            PointG2(PSI2_CX * x, PSI2_CY * y, one),
            PointG2(PSI3_CX * xb, -(PSI3_CY * yb), one)]


def psi(q: PointG2) -> PointG2:
    """ψ(Q) for any Q on the twist (not only the r-order subgroup)."""
    if q.is_infinity():
        return q
    x, y = q.to_affine()
    return PointG2(PSI_CX * x.conjugate(), PSI_CY * y.conjugate(), Fp2.one())


def psi2(q: PointG2) -> PointG2:
    if q.is_infinity():
        return q
    x, y = q.to_affine()
    return PointG2(PSI2_CX * x, PSI2_CY * y, Fp2.one())


def psi3(q: PointG2) -> PointG2:
    if q.is_infinity():
        return q
    x, y = q.to_affine()
    return PointG2(PSI3_CX * x.conjugate(), PSI3_CY * y.conjugate(),
                   Fp2.one())


def _mul_int(q: PointG2, k: int) -> PointG2:
    """Signed scalar multiplication by a (possibly negative) int."""
    if k < 0:
        return -(q.mul(-k))
    return q.mul(k)


def subgroup_check_fast(q: PointG2) -> bool:
    """Q ∈ G2 (r-order subgroup) ⟺ ψ(Q) == [x]Q (Scott's criterion for
    BLS12-381). Q must be on the twist curve."""
    if q.is_infinity():
        return True
    return psi(q) == _mul_int(q, X_BLS)


def _validate() -> None:
    g = PointG2.generator().mul(0x77AB12)
    if psi(g) != _mul_int(g, X_BLS):
        raise ValueError("psi eigenvalue check failed")
    if psi2(g) != psi(psi(g)):
        raise ValueError("psi2 != psi∘psi")
    if psi3(g) != psi(psi2(g)):
        raise ValueError("psi3 != psi∘psi2")
    if not subgroup_check_fast(g):
        raise ValueError("fast subgroup check rejected a subgroup point")
    # the 4-D GLS identity on one wide scalar: Σ d_k·[M^k]P == c·P
    c = 0x6AF3_19C2_0000_0001_DEAD_BEEF_0000_7777_0123_4567_89AB_CDEF_FFFF_FFFF_0000_0003 % R
    basis = gls4_points_from_affine(*g.to_affine())
    acc = PointG2.infinity()
    for pt, d in zip(basis, gls4_decompose(c)):
        acc = acc + pt.mul(d)
    if acc != _mul_int(g, c):
        raise ValueError("GLS4 decomposition check failed")


_validate()
