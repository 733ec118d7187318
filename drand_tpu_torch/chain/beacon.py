"""The chain data model: Beacon, message derivation, verification.

Reference: chain/beacon.go. A beacon's randomness is SHA-256 of its
signature; V1 signatures chain over the previous signature, the fork's V2
signatures cover only the round number (enabling timelock encryption).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from ..crypto.curves import PointG1
from ..crypto import tbls


def round_to_bytes(round_no: int) -> bytes:
    """8-byte big-endian round encoding (chain/store.go:40)."""
    return round_no.to_bytes(8, "big")


def message(curr_round: int, prev_sig: bytes) -> bytes:
    """V1 signing message: H(prevSig || round) (chain/beacon.go:103)."""
    h = hashlib.sha256()
    h.update(prev_sig)
    h.update(round_to_bytes(curr_round))
    return h.digest()


def message_v2(curr_round: int) -> bytes:
    """V2 signing message: H(round) only — unchained (chain/beacon.go:110)."""
    return hashlib.sha256(round_to_bytes(curr_round)).digest()


def randomness_from_signature(sig: bytes) -> bytes:
    return hashlib.sha256(sig).digest()


@dataclass(slots=True)
class Beacon:
    """One round of the chain (chain/beacon.go:16). Slotted: catch-up
    walks materialize and field-scan millions of these."""

    round: int = 0
    previous_sig: bytes = b""
    signature: bytes = b""
    signature_v2: bytes = b""

    def is_v2(self) -> bool:
        return len(self.signature_v2) > 0

    def randomness(self) -> bytes:
        return randomness_from_signature(self.signature)

    def randomness_v2(self) -> bytes:
        return randomness_from_signature(self.signature_v2)

    def equal(self, other: "Beacon") -> bool:
        return (
            self.round == other.round
            and self.previous_sig == other.previous_sig
            and self.signature == other.signature
            and self.signature_v2 == other.signature_v2
        )

    # hex-JSON codec (reference uses nikkolasg/hexjson for storage)
    def marshal(self) -> bytes:
        d = {
            "round": self.round,
            "previous_sig": self.previous_sig.hex(),
            "signature": self.signature.hex(),
        }
        if self.signature_v2:
            d["signature_v2"] = self.signature_v2.hex()
        return json.dumps(d, sort_keys=True).encode()

    @staticmethod
    def unmarshal(data: bytes) -> "Beacon":
        d = json.loads(data)
        return Beacon(
            round=d["round"],
            previous_sig=bytes.fromhex(d["previous_sig"]),
            signature=bytes.fromhex(d["signature"]),
            signature_v2=bytes.fromhex(d.get("signature_v2", "")),
        )

    def __str__(self) -> str:
        return (
            f"{{round: {self.round}, sig: {self.signature[:3].hex()}, "
            f"sig2: {self.signature_v2[:3].hex()}, prev: {self.previous_sig[:3].hex()}}}"
        )


def verify_beacon(pubkey: PointG1, b: Beacon) -> bool:
    """V1 chained verification against the distributed public key
    (chain/beacon.go:87). Returns False rather than raising: beacons arrive
    from untrusted peers."""
    return tbls.verify_recovered(pubkey, message(b.round, b.previous_sig), b.signature)


def verify_beacon_v2(pubkey: PointG1, b: Beacon) -> bool:
    """V2 unchained verification (chain/beacon.go:94)."""
    return tbls.verify_recovered(pubkey, message_v2(b.round), b.signature_v2)
