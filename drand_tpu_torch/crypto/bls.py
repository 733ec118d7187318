"""Plain BLS signatures on G2 with G1 public keys.

This is the reference's AuthScheme (key/curve.go:34, sign.NewSchemeOnG2):
identity self-signatures (key/keys.go:60-88) and group-transport auth.
Verification equation: e(-G1, sig) * e(pub, H(msg)) == 1.
"""

from __future__ import annotations

import secrets

from .fields import R, fr_from_seed
from .curves import PointG1, PointG2
from .hash_to_curve import DEFAULT_DST_G2, hash_to_g2
from .pairing import pairing_check


def keygen(seed: bytes | None = None) -> tuple[int, PointG1]:
    """(private scalar, public key = sk*G1)."""
    if seed is None:
        sk = secrets.randbelow(R - 1) + 1
    else:
        sk = fr_from_seed(b"drand-tpu-keygen", seed)
    return sk, PointG1.generator().mul(sk)


def sign(sk: int, msg: bytes, dst: bytes = DEFAULT_DST_G2) -> bytes:
    """sig = sk * H(msg) on G2, 96-byte compressed."""
    return hash_to_g2(msg, dst).mul(sk).to_bytes()


def verify(pub: PointG1, msg: bytes, sig: bytes, dst: bytes = DEFAULT_DST_G2) -> bool:
    """Pairing check; False on any malformed input (never raises on bad
    signatures — ingress data is untrusted)."""
    try:
        s = PointG2.from_bytes(sig)
    except ValueError:
        return False
    if s.is_infinity() or pub.is_infinity():
        return False
    return pairing_check([(-PointG1.generator(), s), (pub, hash_to_g2(msg, dst))])
