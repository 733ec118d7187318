"""Batched BLS verification engine on the card — slice 1 of the port.

Counterpart of the JAX package's ``BatchedEngine`` (``drand_tpu/ops/
engine.py``) for its ``verify_bls`` family, in the configuration where
every check goes through ``verify_bls`` (no wire tier, no RLC tier):

- ``verify_bls``: a batch of (pub, sig, H(msg)) triples, padded to a
  bucket (4, 128 or 512) and checked by the two CUDA kernels of
  ``ops/pairing.py``; larger batches run as several top-bucket launches
  and are read back once;
- ``verify_beacons``: V1 (chained) + V2 checks of a span of rounds,
  flattened into one ``verify_bls`` call (the reference's catch-up
  verifier, client/verify.go:146-163);
- ``verify_sigs``: (msg, sig) pairs against one public key
  (chain/beacon/chain.go:141);
- ``verify_partials``: one round's partials against their share public
  keys, computed on the host with ``PubPoly.eval`` (node.go:112).

Hashing to G2 and signature decompression run on the host, as the JAX
engine's per-check path does. ``device=None`` means ``cuda``; without
CUDA the constructor raises — it never moves to the CPU on its own. With
``device="cpu"`` the kernels' plain PyTorch versions run (the tests).

Each bucket passes a known-answer gate before first use (the JAX engine's
probe, all lanes must match); on failure the engine RAISES: there is no
fallback to the CPU or to the host oracle.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import metrics
from ..chain import beacon as chain_beacon
from ..crypto import bls, tbls
from ..crypto.curves import PointG1, PointG2
from ..crypto.hash_to_curve import DEFAULT_DST_G2, hash_to_g2
from ..crypto.poly import PubPoly
from . import pairing
from .limb import NWORDS, fp_words

DEFAULT_BUCKETS = (4, 128, 512)
_MSG_CACHE_MAX = 4096


def _g1_xy(xy) -> np.ndarray:
    x, y = xy
    return np.stack([fp_words(x.v), fp_words(y.v)])


def _g2_xy(xy) -> np.ndarray:
    x, y = xy
    return np.stack([np.stack([fp_words(x.c0), fp_words(x.c1)]),
                     np.stack([fp_words(y.c0), fp_words(y.c1)])])


def decode_sig(sig_bytes: bytes) -> PointG2 | None:
    """Wire signature -> subgroup-checked point, or None when it must be
    rejected: malformed, at infinity, or outside the order-r subgroup
    (the accept set of the JAX engine's ``_decode_sig``)."""
    try:
        pt = PointG2.from_bytes(sig_bytes, subgroup_check=True)
    except ValueError:
        return None
    return None if pt.is_infinity() else pt


class BatchedEngine:
    """Bucketed batch verifier on one device."""

    def __init__(self, device=None, buckets=DEFAULT_BUCKETS):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedEngine: CUDA is not available; pass device='cpu' to "
                "run the kernels' plain versions")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"BatchedEngine: unsupported device {dev}")
        if not buckets or min(buckets) < 2:
            raise ValueError("buckets must hold sizes >= 2")
        self.device = dev
        self.buckets = tuple(sorted(buckets))
        self._msg_cache: dict[tuple[bytes, bytes], PointG2] = {}
        self._bucket_ok: dict[int, bool] = {}
        # host vs device seconds of the public calls, summed (hash =
        # hash-to-G2, decode = signature decompression + subgroup check,
        # pack = affine conversion + word packing, device = kernels)
        self.stage_seconds = {"hash": 0.0, "decode": 0.0, "pack": 0.0,
                              "device": 0.0}

    # ------------------------------------------------------------ host prep
    def _hash_msg(self, msg: bytes, dst: bytes) -> PointG2:
        key = (msg, dst)
        got = self._msg_cache.get(key)
        if got is None:
            t0 = time.perf_counter()
            if len(self._msg_cache) > _MSG_CACHE_MAX:
                self._msg_cache.clear()
            got = hash_to_g2(msg, dst)
            self._msg_cache[key] = got
            self.stage_seconds["hash"] += time.perf_counter() - t0
        return got

    def _decode_sig(self, sig_bytes: bytes) -> PointG2 | None:
        t0 = time.perf_counter()
        pt = decode_sig(sig_bytes)
        self.stage_seconds["decode"] += time.perf_counter() - t0
        return pt

    def _pack_bucket(self, triples, b: int):
        """Host arrays of one padded bucket -> (pub, sig, msg tensors on
        the device, valid mask, count). Pad rows and rows with a missing
        or infinite point hold the generators (they verify True and are
        masked out by ``valid``)."""
        t0 = time.perf_counter()
        pubs = np.empty((b, 2, NWORDS), np.int32)
        sigs = np.empty((b, 2, 2, NWORDS), np.int32)
        msgs = np.empty((b, 2, 2, NWORDS), np.int32)
        valid = np.zeros(b, dtype=bool)
        pubs[:] = _g1_xy(PointG1.generator().to_affine())
        sigs[:] = msgs[:] = _g2_xy(PointG2.generator().to_affine())
        rows, g1s, g2s = [], [], []
        for i, (pub, sig, msg_pt) in enumerate(triples):
            if sig is None or sig.is_infinity() or pub.is_infinity() \
                    or msg_pt.is_infinity():
                continue
            rows.append(i)
            g1s.append(pub)
            g2s += [sig, msg_pt]
        g1_xy = PointG1.batch_to_affine(g1s)
        g2_xy = PointG2.batch_to_affine(g2s)
        for j, i in enumerate(rows):
            pubs[i] = _g1_xy(g1_xy[j])
            sigs[i] = _g2_xy(g2_xy[2 * j])
            msgs[i] = _g2_xy(g2_xy[2 * j + 1])
            valid[i] = True
        dev = [torch.from_numpy(a).to(self.device) for a in (pubs, sigs, msgs)]
        self.stage_seconds["pack"] += time.perf_counter() - t0
        return dev, valid, len(triples)

    # ------------------------------------------------------- bucket gate
    def _known_answer_triples(self):
        sk = 0x5A17
        pub = PointG1.generator().mul(sk)
        m_ok, m_bad = b"engine-bucket-check-ok", b"engine-bucket-check-bad"
        sig_ok = PointG2.from_bytes(bls.sign(sk, m_ok), subgroup_check=False)
        return [(pub, sig_ok, self._hash_msg(m_ok, DEFAULT_DST_G2)),
                (pub, sig_ok, self._hash_msg(m_bad, DEFAULT_DST_G2))]

    def check_bucket(self, b: int) -> None:
        """Known-answer gate of bucket b, run once: row 0 must verify,
        row 1 must not, and every pad row (the generator triple) must
        verify — all lanes, as the JAX engine's gate. Raises on failure."""
        if self._bucket_ok.get(b):
            return
        (pubs, sigs, msgs), valid, _ = self._pack_bucket(
            self._known_answer_triples(), b)
        full = pairing.verify_prepared(pubs, sigs, msgs).cpu().numpy()
        ok = (bool(full[0]) and not bool(full[1]) and bool(full[2:].all())
              and bool(valid[:2].all()))
        self._bucket_ok[b] = ok
        if not ok:
            raise RuntimeError(
                f"BatchedEngine: bucket {b} failed its known-answer test on "
                f"{self.device}")

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # -------------------------------------------------------------- verify
    def verify_bls(self, triples) -> np.ndarray:
        """Batch-verify ``(pub: PointG1, sig: PointG2 | None, msg_point:
        PointG2)`` triples; a None signature marks an entry already known
        invalid (failed decode). Returns a bool array of len(triples)."""
        n = len(triples)
        if n == 0:
            return np.zeros(0, dtype=bool)
        b = self._bucket(n)
        self.check_bucket(b)
        metrics.meter_rows(n)
        packed = [self._pack_bucket(triples[i:i + b], b)
                  for i in range(0, n, b)]
        t0 = time.perf_counter()
        oks = [pairing.verify_prepared(*dev) for dev, _, _ in packed]
        host = torch.stack(oks).cpu().numpy()   # one read-back, one sync
        self.stage_seconds["device"] += time.perf_counter() - t0
        return np.concatenate([(host[j] & valid)[:c]
                               for j, (_, valid, c) in enumerate(packed)])

    def verify_beacons(self, pubkey: PointG1, beacons,
                       dst: bytes = DEFAULT_DST_G2) -> np.ndarray:
        """Dual-verify a span of beacons (V1 chained message, plus V2 when
        present) in one flattened ``verify_bls`` call; per-beacon bools."""
        triples, spans = [], []
        for bcn in beacons:
            start = len(triples)
            msg = chain_beacon.message(bcn.round, bcn.previous_sig)
            triples.append((pubkey, self._decode_sig(bcn.signature),
                            self._hash_msg(msg, dst)))
            if bcn.is_v2():
                msg2 = chain_beacon.message_v2(bcn.round)
                triples.append((pubkey, self._decode_sig(bcn.signature_v2),
                                self._hash_msg(msg2, dst)))
            spans.append((start, len(triples) - start))
        flat = self.verify_bls(triples)
        return np.array([bool(flat[s:s + c].all()) for s, c in spans],
                        dtype=bool)

    def verify_sigs(self, pubkey: PointG1, pairs,
                    dst: bytes = DEFAULT_DST_G2) -> list[bool]:
        """(msg, sig_bytes) full-signature checks against one public key."""
        triples = [(pubkey, self._decode_sig(sig), self._hash_msg(msg, dst))
                   for msg, sig in pairs]
        return [bool(v) for v in self.verify_bls(triples)]

    def verify_partials(self, pub_poly: PubPoly, msg: bytes, partials,
                        dst: bytes = DEFAULT_DST_G2) -> list[bool]:
        """All partials of one round against their share public keys
        (``pub_poly.eval`` on the host); a malformed partial is False."""
        msg_pt = self._hash_msg(msg, dst)
        triples = []
        for p in partials:
            if len(p) != tbls.PARTIAL_SIG_SIZE:
                triples.append((PointG1.generator(), None, msg_pt))
                continue
            pk = pub_poly.eval(tbls.index_of(p)).value
            triples.append((pk, self._decode_sig(p[tbls.INDEX_BYTES:]),
                            msg_pt))
        return [bool(v) for v in self.verify_bls(triples)]

    # ------------------------------------------------------- introspection
    def introspect(self) -> dict:
        """JSON-ready state: device, buckets and the per-bucket gate
        verdicts (shapes not listed were never dispatched)."""
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {
            "backend": self.device.type,
            "devices": [name],
            "buckets": list(self.buckets),
            "kat": {"verify": {str(b): ok for b, ok
                               in sorted(self._bucket_ok.items())}},
            "stage_seconds": dict(self.stage_seconds),
        }
