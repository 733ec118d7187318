"""Optimal ate pairing on BLS12-381.

e : G1 x G2 -> GT (order-r subgroup of Fp12*). Used for BLS signature
verification — the reference's hot call sites are VerifyPartial /
VerifyRecovered (drand chain/beacon/node.go:112,
drand chain/beacon/chain.go:141, drand chain/beacon.go:87).

Design notes:
- The twist untwisting constants are PROBED at import (try both M/D-twist
  embeddings, keep the one that lands on E(Fp12)), so no hard-coded
  twist-type assumption can be silently wrong.
- ``multi_pairing`` shares the Miller-loop squarings and the final
  exponentiation across all pairs — this is the product-of-pairings
  optimization the TPU batch verifier mirrors (SURVEY.md §5 long-context
  analogue: chain catch-up as one batched multi-pairing).
- The fast final exponentiation uses the standard Hayashida et al. chain
  (which natively produces the CUBE of the canonical pairing) followed by a
  3^-1 mod r correction, so ``pairing``/``multi_pairing`` return the
  canonical optimal-ate value. ``pairing_check`` skips the correction.
"""

from __future__ import annotations

from .fields import P, R, X_BLS, XI, Fp2, Fp6, Fp12
from .curves import PointG1, PointG2

# Lightweight op counters (plain ints — read/reset by tests and bench).
# The RLC batch verifier's acceptance criterion is "one 2-pairing product
# check for a whole all-valid span"; these make that claim checkable
# without monkeypatching the hot path.
N_PRODUCT_CHECKS = 0   # multi_pairing invocations that ran a Miller loop
N_MILLER_PAIRS = 0     # total (P, Q) pairs fed through Miller loops


# ---------------------------------------------------------------------------
# Monomials c * w^k  (c in Fp2, 0 <= k < 6) — sparse Fp12 elements used for
# the untwist map and line construction.
# ---------------------------------------------------------------------------

class _Mono:
    __slots__ = ("k", "c")

    def __init__(self, k: int, c: Fp2):
        # normalize: w^6 = xi
        q, k = divmod(k, 6)
        if q:
            c = c * XI.pow(q)
        self.k = k
        self.c = c

    def __mul__(self, o: "_Mono") -> "_Mono":
        return _Mono(self.k + o.k, self.c * o.c)

    def inverse(self) -> "_Mono":
        # (c w^k)^-1 = c^-1 w^-k = c^-1 xi^-1 w^(6-k)
        if self.k == 0:
            return _Mono(0, self.c.inverse())
        return _Mono(6 - self.k, (self.c * XI).inverse())

    def apply(self, x: Fp2) -> Fp12:
        """Return (x * c) placed in w-slot k as a full Fp12 element."""
        coeffs = [Fp2.zero()] * 6
        coeffs[self.k] = x * self.c
        return Fp12._from_w_coeffs(coeffs)


def _emb(x: Fp2) -> Fp12:
    return Fp12.from_fp2(x)


def _probe_untwist() -> tuple[_Mono, _Mono]:
    """Find the untwist map (x, y) -> (x*WX, y*WY) from the twist
    E'(Fp2): y^2 = x^3 + 4(1+u) onto E(Fp12): y^2 = x^3 + 4.

    Tries both twist orientations; asserts exactly one works.
    """
    gx, gy = PointG2.GENERATOR_AFFINE
    candidates = [
        (_Mono(2, Fp2.one()), _Mono(3, Fp2.one())),          # D-type: (x w^2, y w^3)
        (_Mono(2, Fp2.one()).inverse(), _Mono(3, Fp2.one()).inverse()),  # M-type
    ]
    four = _emb(Fp2(4, 0))
    found = []
    for wx, wy in candidates:
        X = wx.apply(gx)
        Y = wy.apply(gy)
        if Y * Y == X * X * X + four:
            found.append((wx, wy))
    assert len(found) == 1, f"untwist probe found {len(found)} candidates"
    return found[0]


_WX, _WY = _probe_untwist()
# Line-construction constants: lambda_12 = K_LAMBDA.apply(lambda_2), etc.
_K_LAMBDA = _WX * _WX * _WY.inverse()
_K_LX = _K_LAMBDA * _WX


def untwist(q: PointG2) -> tuple[Fp12, Fp12]:
    """Affine coordinates of q mapped onto E(Fp12)."""
    x, y = q.to_affine()
    return _WX.apply(x), _WY.apply(y)


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------

_MILLER_BITS = bin(abs(X_BLS))[3:]  # MSB is implicit starting value


def _line_value(t: tuple[Fp2, Fp2], lam2: Fp2, p_aff: tuple[int, int]) -> Fp12:
    """Value at the embedded G1 point of the line through untwist(t) with
    untwisted slope lambda = K_LAMBDA(lam2).

    l = y_P - y_T' - lambda * (x_P - x_T')
    """
    xt, yt = t
    xp, yp = p_aff
    out = _emb(Fp2(yp, 0)) - _WY.apply(yt) - _K_LAMBDA.apply(lam2.mul_scalar(xp)) \
        + _K_LX.apply(lam2 * xt)
    return out


def miller_loop(pairs: list[tuple[PointG1, PointG2]]) -> Fp12:
    """Shared-squaring Miller loop over |x| for a list of (P, Q) pairs.

    Points must not be at infinity (callers filter; pairing() handles it).
    One group of :func:`miller_loop_groups` — a single Miller-loop
    implementation serves both the plain and the grouped product checks.
    """
    return miller_loop_groups([pairs])[0]


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------

_HARD_EXP = (X_BLS - 1) ** 2 * (X_BLS + P) * (X_BLS**2 + P**2 - 1) + 3
assert _HARD_EXP == 3 * ((P**4 - P**2 + 1) // R)
# The Hayashida chain computes the CUBE of the canonical ate pairing.
# GT has order r and gcd(3, r) = 1, so cubing is invertible: raising the
# cubed value to 3^-1 mod r recovers the canonical pairing.
_INV3_MOD_R = pow(3, -1, R)


def final_exponentiation_slow(f: Fp12, canonical: bool = True) -> Fp12:
    """Obviously-correct path: easy part then one generic pow. Golden
    reference for the fast chain below."""
    f1 = f.conjugate() * f.inverse()        # f^(p^6 - 1)
    f2 = f1.frobenius(2) * f1               # ^(p^2 + 1) — now cyclotomic
    exp = (P**4 - P**2 + 1) // R if canonical else _HARD_EXP
    return f2.pow(exp)


def final_exponentiation(f: Fp12, canonical: bool = True) -> Fp12:
    """Fast path: easy part + Hayashida et al. chain
    m^((x-1)^2 (x+p) (x^2+p^2-1)) * m^3, all in the cyclotomic subgroup.

    With canonical=True (default) the cube is corrected so the result is the
    canonical optimal-ate pairing value, interoperable with other BLS12-381
    implementations (matters for GT consumers like timelock IBE). Equality
    checks (pairing_check) skip the correction — cubing preserves equality.
    """
    f1 = f.conjugate() * f.inverse()
    m = f1.frobenius(2) * f1
    a = m.cyclotomic_pow(X_BLS - 1)
    a = a.cyclotomic_pow(X_BLS - 1)
    a = a.cyclotomic_pow(X_BLS) * a.frobenius(1)            # ^(x+p)
    a = a.cyclotomic_pow(X_BLS).cyclotomic_pow(X_BLS) \
        * a.frobenius(2) * a.conjugate()                     # ^(x^2+p^2-1)
    cubed = a * m * m.cyclotomic_square()                    # * m^3
    return cubed.cyclotomic_pow(_INV3_MOD_R) if canonical else cubed


def multi_pairing(pairs: list[tuple[PointG1, PointG2]], canonical: bool = True) -> Fp12:
    """prod_i e(P_i, Q_i) with shared Miller squarings and one final exp."""
    live = [(p, q) for (p, q) in pairs if not p.is_infinity() and not q.is_infinity()]
    if not live:
        return Fp12.one()
    global N_PRODUCT_CHECKS, N_MILLER_PAIRS
    N_PRODUCT_CHECKS += 1
    N_MILLER_PAIRS += len(live)
    return final_exponentiation(miller_loop(live), canonical=canonical)


def pairing(p: PointG1, q: PointG2) -> Fp12:
    """The canonical optimal-ate pairing e(P, Q)."""
    return multi_pairing([(p, q)])


def miller_loop_groups(groups: list[list[tuple[PointG1, PointG2]]]) -> list[Fp12]:
    """Per-group Miller values in ONE pass over the |x| bits: line/T
    updates are per-pair exactly as in :func:`miller_loop`, but each
    group keeps its own accumulator (squared per bit), so one invocation
    yields independent products. Points must not be at infinity (callers
    filter). Empty groups yield Fp12.one()."""
    flat = [(g, p, q) for g, grp in enumerate(groups) for (p, q) in grp]
    p_affs, q_affs, gids = [], [], []
    for g, pt, q in flat:
        xa, ya = pt.to_affine()
        p_affs.append((xa.v, ya.v))
        q_affs.append(q.to_affine())
        gids.append(g)

    ts = list(q_affs)
    fs = [Fp12.one()] * len(groups)
    three = 3
    for bit in _MILLER_BITS:
        fs = [f.square() for f in fs]
        for i, g in enumerate(gids):
            xt, yt = ts[i]
            lam2 = xt.square().mul_scalar(three) * (yt + yt).inverse()
            fs[g] = fs[g] * _line_value(ts[i], lam2, p_affs[i])
            x3 = lam2.square() - xt - xt
            y3 = lam2 * (xt - x3) - yt
            ts[i] = (x3, y3)
        if bit == "1":
            for i, g in enumerate(gids):
                xt, yt = ts[i]
                xq, yq = q_affs[i]
                lam2 = (yq - yt) * (xq - xt).inverse()
                fs[g] = fs[g] * _line_value(ts[i], lam2, p_affs[i])
                x3 = lam2.square() - xt - xq
                y3 = lam2 * (xt - x3) - yt
                ts[i] = (x3, y3)
    return [f.conjugate() for f in fs]


def pairing_check_groups(groups: list[list[tuple[PointG1, PointG2]]]
                         ) -> list[bool]:
    """Independent product checks (prod e(P_i, Q_i) == 1 per group)
    decided in ONE grouped Miller pass — the batched-bisection primitive:
    a failed RLC span verifies BOTH halves as one 4-pairing dispatch
    instead of two sequential 2-pairing checks. Counts as one product
    check at the meter (one invocation; the per-pair Miller work is what
    N_MILLER_PAIRS tracks). A group whose pairs are all infinity-filtered
    is vacuously True, matching pairing_check on the same input."""
    live_groups = [[(p, q) for (p, q) in grp
                    if not p.is_infinity() and not q.is_infinity()]
                   for grp in groups]
    if not any(live_groups):
        return [True] * len(groups)
    global N_PRODUCT_CHECKS, N_MILLER_PAIRS
    N_PRODUCT_CHECKS += 1
    N_MILLER_PAIRS += sum(len(g) for g in live_groups)
    fs = miller_loop_groups(live_groups)
    return [final_exponentiation(f, canonical=False).is_one()
            if grp else True
            for f, grp in zip(fs, live_groups)]


def pairing_check(pairs: list[tuple[PointG1, PointG2]]) -> bool:
    """True iff prod e(P_i, Q_i) == 1 in GT (skips the cube correction —
    equality with 1 is invariant under cubing)."""
    return multi_pairing(pairs, canonical=False).is_one()
