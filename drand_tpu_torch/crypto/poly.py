"""Secret-sharing polynomials over Fr and their G1 commitments.

Replaces kyber's share.PriPoly / share.PubPoly / share.PriShare as used by
the reference (key/keys.go:235-244, chain/beacon/node.go:110,
chain/beacon/chain.go:136). Share indices follow kyber's convention:
share i evaluates the polynomial at x = i + 1 (x = 0 is the secret).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .fields import R, fr_inv
from .curves import PointG1, PointG2, _JacobianPoint


@dataclass(frozen=True)
class PriShare:
    """Private share: (index, scalar). kyber share.PriShare analogue."""

    index: int
    value: int  # in Fr

    def hash(self) -> bytes:
        h = hashlib.blake2b(digest_size=32)
        h.update(self.index.to_bytes(2, "big"))
        h.update(self.value.to_bytes(32, "big"))
        return h.digest()


@dataclass(frozen=True)
class PubShare:
    """Public share: (index, group point)."""

    index: int
    value: _JacobianPoint


def _x_of(index: int) -> int:
    """Evaluation abscissa for a share index (kyber: x = index + 1)."""
    return index + 1


class PriPoly:
    """Secret polynomial f of degree t-1 over Fr; f(0) is the secret."""

    def __init__(self, coeffs: list[int]):
        if not coeffs:
            raise ValueError("polynomial needs at least one coefficient")
        self.coeffs = [c % R for c in coeffs]

    @staticmethod
    def random(t: int, seed: bytes | None = None) -> "PriPoly":
        """Degree t-1 polynomial. With seed, deterministic (tests/DKG
        derivation); without, from OS entropy."""
        import secrets

        from .fields import fr_from_seed

        coeffs = []
        for i in range(t):
            if seed is None:
                coeffs.append(secrets.randbelow(R - 1) + 1)
            else:
                coeffs.append(fr_from_seed(b"dkg-poly", seed + i.to_bytes(4, "big")))
        return PriPoly(coeffs)

    @property
    def threshold(self) -> int:
        return len(self.coeffs)

    def secret(self) -> int:
        return self.coeffs[0]

    def eval(self, index: int) -> PriShare:
        x = _x_of(index)
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % R
        return PriShare(index, acc)

    def eval_many(self, indices: list[int]) -> list[PriShare]:
        """All shares in ONE Horner sweep: per coefficient, one vectorized
        lane update instead of n independent walks — the dealing-side
        batch for large-group DKG (a n=1024 dealer evaluates its poly at
        every receiver index)."""
        xs = [_x_of(i) for i in indices]
        accs = [0] * len(xs)
        for c in reversed(self.coeffs):
            accs = [(a * x + c) % R for a, x in zip(accs, xs)]
        return [PriShare(i, a) for i, a in zip(indices, accs)]

    def shares(self, n: int) -> list[PriShare]:
        return [self.eval(i) for i in range(n)]

    def commit(self, base: _JacobianPoint | None = None) -> "PubPoly":
        if base is None:
            # fixed-base comb for the default G1 generator — same group
            # elements as generator().mul(c), ~8x cheaper per coefficient
            from .curves import g1_comb_mul

            return PubPoly([g1_comb_mul(c) for c in self.coeffs],
                           PointG1.generator())
        return PubPoly([base.mul(c) for c in self.coeffs], base)

    def add(self, other: "PriPoly") -> "PriPoly":
        if self.threshold != other.threshold:
            raise ValueError("threshold mismatch")
        return PriPoly([(a + b) % R for a, b in zip(self.coeffs, other.coeffs)])


class PubPoly:
    """Committed polynomial: commits[k] = [a_k] * base.

    eval(i) gives node i's public key share — the verification key for its
    partial signatures (reference: chain/beacon/node.go:110 PubPoly.Eval).
    """

    def __init__(self, commits: list[_JacobianPoint], base: _JacobianPoint | None = None):
        if not commits:
            raise ValueError("empty commitment list")
        self.commits = commits
        self.base = base if base is not None else PointG1.generator()
        self._eval_cache: dict[int, PubShare] = {}

    @property
    def threshold(self) -> int:
        return len(self.commits)

    def commit(self) -> _JacobianPoint:
        """The commitment to the secret: the distributed public key."""
        return self.commits[0]

    def eval(self, index: int) -> PubShare:
        """Node `index`'s public key share (memoized — the beacon verifies
        against the same handful of indices every round)."""
        cached = self._eval_cache.get(index)
        if cached is not None:
            return cached
        x = _x_of(index)
        acc = type(self.commits[0]).infinity()
        for c in reversed(self.commits):
            acc = acc.mul(x) + c
        share = PubShare(index, acc)
        self._eval_cache[index] = share
        return share

    def eval_many(self, indices: list[int]) -> list[PubShare]:
        """Host multi-point evaluation (memoized per index). This is the
        exact ORACLE for the batched forms of the same computation — the
        device `engine.eval_poly_indices` dispatch and the msm-backed RLC
        binding verdict both route through `crypto.batch.eval_poly_indices`
        / `batch_verify.reshare_bindings_rlc`, which fall back to and are
        bisection-checked against this loop."""
        return [self.eval(i) for i in indices]

    def add(self, other: "PubPoly") -> "PubPoly":
        if self.threshold != other.threshold:
            raise ValueError("threshold mismatch")
        return PubPoly([a + b for a, b in zip(self.commits, other.commits)], self.base)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PubPoly)
            and self.base == other.base
            and self.commits == other.commits
        )


def lagrange_coefficients(indices: list[int]) -> dict[int, int]:
    """lambda_i for interpolation at x=0 over the given share indices."""
    lambdas = {}
    for i in indices:
        xi = _x_of(i)
        num, den = 1, 1
        for j in indices:
            if j == i:
                continue
            xj = _x_of(j)
            num = (num * xj) % R
            den = (den * (xj - xi)) % R
        lambdas[i] = (num * fr_inv(den)) % R
    return lambdas


def recover_secret(shares: list[PriShare], t: int) -> int:
    """Lagrange-interpolate f(0) from >= t private shares."""
    if len(shares) < t:
        raise ValueError(f"need {t} shares, got {len(shares)}")
    use = shares[:t]
    lambdas = lagrange_coefficients([s.index for s in use])
    return sum(s.value * lambdas[s.index] for s in use) % R


def recover_commit(shares: list[PubShare], t: int) -> _JacobianPoint:
    """Lagrange-interpolate the group point at x=0 from >= t public shares.

    This is the signature-recovery hot path (reference:
    chain/beacon/chain.go:136 Scheme.Recover -> Lagrange on G2); the TPU
    engine provides the batched MSM version.
    """
    if len(shares) < t:
        raise ValueError(f"need {t} shares, got {len(shares)}")
    use = shares[:t]
    lambdas = lagrange_coefficients([s.index for s in use])
    cls = type(use[0].value)
    acc = cls.infinity()
    for s in use:
        acc = acc + s.value.mul(lambdas[s.index])
    return acc


def minimum_threshold(n: int) -> int:
    """vss.MinimumT analogue (reference: core/drand_control.go:641,
    key/keys.go:390): floor(n/2) + 1."""
    return n // 2 + 1
