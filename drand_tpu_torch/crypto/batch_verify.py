"""Scalars of the randomized linear combination (RLC) batch check.

Own copy of ``RLC_SCALAR_BITS`` and ``rlc_scalars`` of the JAX package's
``crypto/batch_verify.py`` (the rest of that module, the host RLC tiers,
comes with a later slice of the port).

N checks ``e(−g1, σᵢ)·e(pk, H(mᵢ)) == 1`` under one key collapse into
one: ``e(−g1, Σcᵢσᵢ)·e(pk, ΣcᵢH(mᵢ)) == 1`` with independent uniform
nonzero 128-bit scalars cᵢ. With every σᵢ decoded and subgroup-checked
before it enters the sum, a span with a bad signature passes with
probability at most 2^-128. The scalars come from ``secrets`` and must
stay unpredictable: an adversary who knows them can submit two invalid
signatures that cancel in the sum. A zero scalar would drop its item
from the check, so scalars are drawn nonzero.
"""

from __future__ import annotations

import secrets

RLC_SCALAR_BITS = 128


def rlc_scalars(n: int) -> list[int]:
    """n independent uniform nonzero 128-bit scalars from the OS CSPRNG."""
    out = []
    for _ in range(n):
        c = 0
        while c == 0:
            c = secrets.randbits(RLC_SCALAR_BITS)
        out.append(c)
    return out
