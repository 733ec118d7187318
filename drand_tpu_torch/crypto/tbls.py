"""Threshold BLS (t-of-n) on G2 — the core beacon scheme.

Replaces kyber tbls.NewThresholdSchemeOnG2 (reference key/curve.go:31) with
the exact API surface the reference consumes (SURVEY.md §2.2):
``sign_partial`` (chain/beacon/crypto.go:58), ``verify_partial``
(chain/beacon/node.go:112), ``index_of`` (chain/beacon/cache.go:42),
``recover`` (chain/beacon/chain.go:136), ``verify_recovered``
(chain/beacon/chain.go:141).

Wire format of a partial signature: 2-byte big-endian share index, then the
96-byte compressed G2 signature (kyber tbls.SigShare layout).

Batched verification/recovery across many partials/rounds is provided by the
CUDA engine (drand_tpu_torch.ops); this module is the exact-semantics host path.
"""

from __future__ import annotations

from .curves import PointG1, PointG2
from .hash_to_curve import DEFAULT_DST_G2, hash_to_g2
from .pairing import pairing_check
from .poly import PriShare, PubPoly, PubShare, recover_commit

INDEX_BYTES = 2
PARTIAL_SIG_SIZE = INDEX_BYTES + PointG2.COMPRESSED_SIZE  # 98
SIG_SIZE = PointG2.COMPRESSED_SIZE  # 96


class RecoveredSignatureInvalid(ValueError):
    """The Lagrange-recovered group signature failed its pairing check —
    security-significant (byzantine partials that individually verified,
    or state corruption), distinct from the routine not-enough-partials
    ValueError so callers can log it loudly."""


def sign_partial(share: PriShare, msg: bytes, dst: bytes = DEFAULT_DST_G2) -> bytes:
    """Partial signature: index-prefixed share-scalar * H(msg)."""
    sig = hash_to_g2(msg, dst).mul(share.value)
    return share.index.to_bytes(INDEX_BYTES, "big") + sig.to_bytes()


def index_of(partial: bytes) -> int:
    """Read the share index from a partial signature's prefix."""
    if len(partial) < INDEX_BYTES:
        raise ValueError("partial signature too short")
    return int.from_bytes(partial[:INDEX_BYTES], "big")


def verify_partial(
    pub_poly: PubPoly, msg: bytes, partial: bytes, dst: bytes = DEFAULT_DST_G2
) -> bool:
    """Check one partial against the signer's public key share
    pub_poly.eval(index). False on malformed input (ingress is untrusted)."""
    if len(partial) != PARTIAL_SIG_SIZE:
        return False
    idx = index_of(partial)
    try:
        sig = PointG2.from_bytes(partial[INDEX_BYTES:])
    except ValueError:
        return False
    if sig.is_infinity():
        return False
    pub_i = pub_poly.eval(idx).value
    return pairing_check([(-PointG1.generator(), sig), (pub_i, hash_to_g2(msg, dst))])


def recover(
    pub_poly: PubPoly,
    msg: bytes,
    partials: list[bytes],
    t: int,
    n: int,
    dst: bytes = DEFAULT_DST_G2,
) -> bytes:
    """Lagrange-recover the unique full BLS signature from >= t partials.

    Like kyber's tbls.Recover, partials are assumed pre-verified (the beacon
    aggregator verifies on ingress and re-verifies the recovered signature —
    chain/beacon/chain.go:136-141); invalid encodings are skipped.
    """
    shares: list[PubShare] = []
    seen: set[int] = set()
    for p in partials:
        if len(p) != PARTIAL_SIG_SIZE:
            continue
        idx = index_of(p)
        if idx in seen or idx >= n:
            continue
        try:
            pt = PointG2.from_bytes(p[INDEX_BYTES:])
        except ValueError:
            continue
        seen.add(idx)
        shares.append(PubShare(idx, pt))
        if len(shares) == t:
            break
    if len(shares) < t:
        raise ValueError(f"not enough valid partials: {len(shares)} < {t}")
    return recover_commit(shares, t).to_bytes()


def verify_recovered(
    pubkey: PointG1, msg: bytes, sig: bytes, dst: bytes = DEFAULT_DST_G2
) -> bool:
    """Verify a recovered (full) signature against the distributed public
    key — identical equation to plain BLS."""
    from . import bls

    return bls.verify(pubkey, msg, sig, dst)
