"""BLS12-381 field towers: Fp, Fp2, Fp6, Fp12 and the scalar field Fr.

Pure-Python reference engine (exact semantics; host signing path). The batched
CUDA engine in ``drand_tpu_torch.ops`` is golden-tested against this module
(a copy of the JAX package's host field code, kept so the port imports
nothing of that package).

Replaces the reference's external crypto stack (kyber-bls12381 wrapping
kilic/bls12-381 — see drand key/curve.go:19-38 for the suite
selection this module underpins).

Tower construction (standard for BLS12-381):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)

All derived constants (Frobenius coefficients, sqrt helpers) are COMPUTED at
import time from p and the tower definition, never hard-coded, so they cannot
be silently wrong: import fails loudly if an invariant breaks.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Base constants (the only hard-coded numbers: curve parameters of BLS12-381)
# ---------------------------------------------------------------------------

# Field modulus p
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order r (the scalar field Fr)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative); p and r are polynomials in x:
#   r = x^4 - x^2 + 1,  p = (x-1)^2/3 * r + x
X_BLS = -0xD201000000010000

assert P % 6 == 1
assert R == X_BLS**4 - X_BLS**2 + 1
assert P == ((X_BLS - 1) ** 2 // 3) * R + X_BLS

FP_BYTES = 48  # big-endian serialized Fp element


# ---------------------------------------------------------------------------
# Fp — represented as plain python ints in [0, P)
# ---------------------------------------------------------------------------

def fp_add(a: int, b: int) -> int:
    return (a + b) % P


def fp_sub(a: int, b: int) -> int:
    return (a - b) % P


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_neg(a: int) -> int:
    return (-a) % P


def fp_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of 0 in Fp")
    return pow(a, -1, P)


def fp_is_square(a: int) -> bool:
    """Euler criterion; 0 counts as square."""
    a %= P
    return a == 0 or pow(a, (P - 1) // 2, P) == 1


_P_PLUS_1_OVER_4 = (P + 1) // 4  # valid since P % 4 == 3


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp, or None if a is not a QR. p ≡ 3 (mod 4)."""
    a %= P
    r = pow(a, _P_PLUS_1_OVER_4, P)
    return r if r * r % P == a else None


def fp_to_bytes(a: int) -> bytes:
    return int(a % P).to_bytes(FP_BYTES, "big")


def fp_from_bytes(b: bytes) -> int:
    if len(b) != FP_BYTES:
        raise ValueError(f"Fp element must be {FP_BYTES} bytes, got {len(b)}")
    v = int.from_bytes(b, "big")
    if v >= P:
        raise ValueError("Fp element not canonical (>= p)")
    return v


class Fp:
    """Object wrapper over the int representation, giving Fp the same duck
    interface as Fp2 so curve/SSWU code can be written once for both."""

    __slots__ = ("v",)

    def __init__(self, v: int = 0):
        self.v = v % P

    @staticmethod
    def zero() -> "Fp":
        return Fp(0)

    @staticmethod
    def one() -> "Fp":
        return Fp(1)

    def is_zero(self) -> bool:
        return self.v == 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Fp) and self.v == other.v

    def __hash__(self):
        return hash(("Fp", self.v))

    def __repr__(self):
        return f"Fp({hex(self.v)})"

    def __add__(self, o: "Fp") -> "Fp":
        return Fp(self.v + o.v)

    def __sub__(self, o: "Fp") -> "Fp":
        return Fp(self.v - o.v)

    def __neg__(self) -> "Fp":
        return Fp(-self.v)

    def __mul__(self, o: "Fp") -> "Fp":
        return Fp(self.v * o.v)

    def mul_scalar(self, k: int) -> "Fp":
        return Fp(self.v * k)

    def square(self) -> "Fp":
        return Fp(self.v * self.v)

    def inverse(self) -> "Fp":
        return Fp(fp_inv(self.v))

    def pow(self, e: int) -> "Fp":
        if e < 0:
            return Fp(pow(fp_inv(self.v), -e, P))
        return Fp(pow(self.v, e, P))

    def sqrt(self) -> "Fp | None":
        r = fp_sqrt(self.v)
        return None if r is None else Fp(r)

    def is_square(self) -> bool:
        return fp_is_square(self.v)

    def sgn0(self) -> int:
        return self.v & 1

    def to_bytes(self) -> bytes:
        return fp_to_bytes(self.v)

    @staticmethod
    def from_bytes(b: bytes) -> "Fp":
        return Fp(fp_from_bytes(b))


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1)
# ---------------------------------------------------------------------------

class Fp2:
    """Element c0 + c1*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int = 0, c1: int = 0):
        self.c0 = c0 % P
        self.c1 = c1 % P

    # -- constructors -------------------------------------------------------
    @staticmethod
    def zero() -> "Fp2":
        return Fp2(0, 0)

    @staticmethod
    def one() -> "Fp2":
        return Fp2(1, 0)

    # -- predicates ---------------------------------------------------------
    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Fp2) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fp2({hex(self.c0)}, {hex(self.c1)})"

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fp2":
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o: "Fp2") -> "Fp2":
        # Karatsuba: (a0+a1 u)(b0+b1 u) = a0b0 - a1b1 + ((a0+a1)(b0+b1)-a0b0-a1b1) u
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        return Fp2(v0 - v1, (self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1)

    def mul_scalar(self, k: int) -> "Fp2":
        return Fp2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fp2":
        # (a+bu)^2 = (a+b)(a-b) + 2ab u
        a, b = self.c0, self.c1
        return Fp2((a + b) * (a - b), 2 * a * b)

    def conjugate(self) -> "Fp2":
        return Fp2(self.c0, -self.c1)

    def inverse(self) -> "Fp2":
        # 1/(a+bu) = (a-bu)/(a^2+b^2)
        norm = self.c0 * self.c0 + self.c1 * self.c1
        t = fp_inv(norm % P)
        return Fp2(self.c0 * t, -self.c1 * t)

    def pow(self, e: int) -> "Fp2":
        if e < 0:
            return self.inverse().pow(-e)
        result = Fp2.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self) -> "Fp2 | None":
        """Square root in Fp2 (p^2 ≡ 9 mod 16), via candidate method."""
        if self.is_zero():
            return Fp2.zero()
        cand = self.pow(_Q2_PLUS_7_OVER_16)
        for root4 in _FP2_ROOTS_OF_UNITY_4:
            r = cand * root4
            if r.square() == self:
                return r
        return None

    def is_square(self) -> bool:
        # norm is a QR in Fp iff element is a QR in Fp2
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        return fp_is_square(norm)

    def frobenius(self) -> "Fp2":
        """x -> x^p (= conjugation since p ≡ 3 mod 4)."""
        return self.conjugate()

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for Fp2 (m=2)."""
        sign_0 = self.c0 & 1
        zero_0 = self.c0 == 0
        sign_1 = self.c1 & 1
        return sign_0 | (zero_0 & sign_1)

    def to_bytes(self) -> bytes:
        """c1 || c0, matching the zcash/kyber G2 x-coordinate layout."""
        return fp_to_bytes(self.c1) + fp_to_bytes(self.c0)

    @staticmethod
    def from_bytes(b: bytes) -> "Fp2":
        if len(b) != 2 * FP_BYTES:
            raise ValueError("Fp2 element must be 96 bytes")
        return Fp2(fp_from_bytes(b[FP_BYTES:]), fp_from_bytes(b[:FP_BYTES]))


# Nonresidue xi = 1 + u used to build Fp6
XI = Fp2(1, 1)

# sqrt helper constants (computed, with self-checks)
_Q2_PLUS_7_OVER_16 = (P * P + 7) // 16
assert (P * P) % 16 == 9


def _compute_fp2_fourth_roots() -> list[Fp2]:
    """The four fourth-roots of unity in Fp2: 1, u, sqrt(u), sqrt(-u)."""
    # sqrt(u) has the form a*(1 ± u): need a^2 = 1/2 (for a+au) or
    # a^2 = -1/2 (for a-au); exactly one of ±1/2 is a QR mod p.
    half = fp_inv(2)
    a = fp_sqrt(half)
    if a is not None:
        c2 = Fp2(a, a)   # (a+au)^2 = 2a^2 u = u
        c3 = Fp2(a, -a)  # (a-au)^2 = -2a^2 u = -u
    else:
        a = fp_sqrt(fp_neg(half))
        assert a is not None, "neither 1/2 nor -1/2 is a QR: impossible"
        c2 = Fp2(a, -a)  # (a-au)^2 = -2a^2 u = u
        c3 = Fp2(a, a)   # (a+au)^2 = 2a^2 u = -u
    assert c2.square() == Fp2(0, 1)
    assert c3.square() == Fp2(0, -1)
    return [Fp2.one(), Fp2(0, 1), c2, c3]


_FP2_ROOTS_OF_UNITY_4 = _compute_fp2_fourth_roots()


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------

class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0 = c0
        self.c1 = c1
        self.c2 = c2

    @staticmethod
    def zero() -> "Fp6":
        return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one() -> "Fp6":
        return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Fp6)
            and self.c0 == other.c0
            and self.c1 == other.c1
            and self.c2 == other.c2
        )

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))

    def __repr__(self):
        return f"Fp6({self.c0!r}, {self.c1!r}, {self.c2!r})"

    def __add__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fp6":
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fp6") -> "Fp6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        v0 = a0 * b0
        v1 = a1 * b1
        v2 = a2 * b2
        c0 = v0 + XI * ((a1 + a2) * (b1 + b2) - v1 - v2)
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + XI * v2
        c2 = (a0 + a2) * (b0 + b2) - v0 + v1 - v2
        return Fp6(c0, c1, c2)

    def square(self) -> "Fp6":
        return self * self

    def mul_fp2(self, k: Fp2) -> "Fp6":
        return Fp6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self) -> "Fp6":
        """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return Fp6(XI * self.c2, self.c0, self.c1)

    def inverse(self) -> "Fp6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - XI * (a1 * a2)
        t1 = XI * a2.square() - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = a0 * t0 + XI * (a2 * t1) + XI * (a1 * t2)
        dinv = denom.inverse()
        return Fp6(t0 * dinv, t1 * dinv, t2 * dinv)


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ---------------------------------------------------------------------------

class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def zero() -> "Fp12":
        return Fp12(Fp6.zero(), Fp6.zero())

    @staticmethod
    def one() -> "Fp12":
        return Fp12(Fp6.one(), Fp6.zero())

    @staticmethod
    def from_fp2(x: Fp2) -> "Fp12":
        return Fp12(Fp6(x, Fp2.zero(), Fp2.zero()), Fp6.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def is_one(self) -> bool:
        return self == Fp12.one()

    def __eq__(self, other) -> bool:
        return isinstance(other, Fp12) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fp12({self.c0!r}, {self.c1!r})"

    def __add__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fp12":
        return Fp12(-self.c0, -self.c1)

    def __mul__(self, o: "Fp12") -> "Fp12":
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        v0 = a0 * b0
        v1 = a1 * b1
        c0 = v0 + v1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1
        return Fp12(c0, c1)

    def square(self) -> "Fp12":
        # complex squaring: (a0 + a1 w)^2 = (a0+a1)(a0 + v a1) - v0 - v*v0' ...
        a0, a1 = self.c0, self.c1
        v0 = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_v()) - v0 - v0.mul_by_v()
        c1 = v0 + v0
        return Fp12(c0, c1)

    def conjugate(self) -> "Fp12":
        """x -> x^(p^6): negate the w-odd half."""
        return Fp12(self.c0, -self.c1)

    def inverse(self) -> "Fp12":
        a0, a1 = self.c0, self.c1
        denom = a0.square() - a1.square().mul_by_v()
        dinv = denom.inverse()
        return Fp12(a0 * dinv, -(a1 * dinv))

    def pow(self, e: int) -> "Fp12":
        if e < 0:
            return self.inverse().pow(-e)
        result = Fp12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    # -- w-basis conversion for Frobenius ----------------------------------
    def _to_w_coeffs(self) -> list[Fp2]:
        """Coefficients of 1, w, w^2(=v), w^3, w^4, w^5 over Fp2."""
        return [
            self.c0.c0, self.c1.c0, self.c0.c1,
            self.c1.c1, self.c0.c2, self.c1.c2,
        ]

    @staticmethod
    def _from_w_coeffs(c: list[Fp2]) -> "Fp12":
        return Fp12(Fp6(c[0], c[2], c[4]), Fp6(c[1], c[3], c[5]))

    def frobenius(self, power: int = 1) -> "Fp12":
        """x -> x^(p^power) using precomputed gamma = xi^(i*(p^k-1)/6)."""
        power %= 12
        if power == 0:
            return self
        gammas = _FROBENIUS_GAMMA[power]
        coeffs = self._to_w_coeffs()
        out = []
        for i, c in enumerate(coeffs):
            ci = c
            # apply coefficient-wise p^power Frobenius of Fp2 (conj if odd)
            if power % 2 == 1:
                ci = ci.conjugate()
            out.append(ci * gammas[i])
        return Fp12._from_w_coeffs(out)

    def cyclotomic_square(self) -> "Fp12":
        """Granger-Scott squaring, valid in the cyclotomic subgroup.

        Golden-tested against ``square`` in tests.
        """
        # represent as (g0..g5) w-coeffs; use standard GS formulas over Fp2
        g0, g1, g2, g3, g4, g5 = self._to_w_coeffs()

        def _sq2(a: Fp2, b: Fp2) -> tuple[Fp2, Fp2]:
            # (a + b*y)^2 in Fp4 = Fp2[y]/(y^2 - xi)
            t0 = a.square()
            t1 = b.square()
            return t0 + XI * t1, (a + b).square() - t0 - t1

        a0, a1 = _sq2(g0, g3)  # Fp4 = Fp2[w^3], (w^3)^2 = xi
        b0, b1 = _sq2(g1, g4)
        c0, c1 = _sq2(g2, g5)

        def _f(goal: Fp2, t: Fp2) -> Fp2:
            return (t - goal).mul_scalar(2) + t  # 3t - 2*goal

        def _g(goal: Fp2, t: Fp2) -> Fp2:
            return (t + goal).mul_scalar(2) + t  # 3t + 2*goal

        h0 = _f(g0, a0)
        h1 = _g(g1, XI * c1)
        h2 = _f(g2, b0)
        h3 = _g(g3, a1)
        h4 = _f(g4, c0)
        h5 = _g(g5, b1)
        return Fp12._from_w_coeffs([h0, h1, h2, h3, h4, h5])

    def cyclotomic_pow(self, e: int) -> "Fp12":
        """Exponentiation using cyclotomic squarings (element must be in the
        cyclotomic subgroup). Negative exponents use conjugation (unitary)."""
        if e < 0:
            return self.conjugate().cyclotomic_pow(-e)
        result = Fp12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.cyclotomic_square()
            e >>= 1
        return result


def _compute_frobenius_gammas() -> dict[int, list[Fp2]]:
    """gamma[k][i] = xi^(i*(p^k-1)/6) for every power k in 1..11."""
    out: dict[int, list[Fp2]] = {}
    for k in range(1, 12):
        pk = P**k
        assert (pk - 1) % 6 == 0
        base = XI.pow((pk - 1) // 6)
        gam = [Fp2.one()]
        for _ in range(5):
            gam.append(gam[-1] * base)
        out[k] = gam
    return out


_FROBENIUS_GAMMA = _compute_frobenius_gammas()


# sanity: frobenius really is x -> x^p (checked on a fixed element at import)
def _frobenius_self_test() -> None:
    x = Fp12(
        Fp6(Fp2(3, 5), Fp2(7, 11), Fp2(13, 17)),
        Fp6(Fp2(19, 23), Fp2(29, 31), Fp2(37, 41)),
    )
    assert x.frobenius(1) == x.pow(P)
    assert x.frobenius(2) == x.frobenius(1).frobenius(1)
    assert x.frobenius(3) == x.frobenius(2).frobenius(1)
    assert x.conjugate() == x.frobenius(3).frobenius(3)


_frobenius_self_test()


# ---------------------------------------------------------------------------
# Fr — scalar field
# ---------------------------------------------------------------------------

FR_BYTES = 32


def fr_add(a: int, b: int) -> int:
    return (a + b) % R


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R


def fr_mul(a: int, b: int) -> int:
    return (a * b) % R


def fr_neg(a: int) -> int:
    return (-a) % R


def fr_inv(a: int) -> int:
    if a % R == 0:
        raise ZeroDivisionError("inverse of 0 in Fr")
    return pow(a, -1, R)


def fr_from_bytes_wide(b: bytes) -> int:
    """Reduce arbitrary-length big-endian bytes mod r (for hashing to Fr)."""
    return int.from_bytes(b, "big") % R


def fr_from_seed(domain: bytes, seed: bytes) -> int:
    """Deterministic NONZERO scalar from a seed: 512-bit SHA-256 widening
    reduced into [1, r). The single derivation used by seeded keygen and
    polynomial sampling — keep it in one place."""
    import hashlib

    h = hashlib.sha256(domain + seed).digest()
    h2 = hashlib.sha256(h).digest()
    return (int.from_bytes(h + h2, "big") % (R - 1)) + 1


def fr_to_bytes(a: int) -> bytes:
    return int(a % R).to_bytes(FR_BYTES, "big")


def fr_from_bytes(b: bytes) -> int:
    if len(b) != FR_BYTES:
        raise ValueError(f"Fr element must be {FR_BYTES} bytes")
    v = int.from_bytes(b, "big")
    if v >= R:
        raise ValueError("Fr element not canonical (>= r)")
    return v
