"""Batched BLS engine on the card: verification (slice 1), the
threshold round (slice 2) and the wire path (slice 3) of the port.

Counterpart of the JAX package's ``BatchedEngine`` (``drand_tpu/ops/
engine.py``) with its per-item, fused-round, wire and wire-RLC tiers
(not yet its host-RLC tiers, its timelock opens or its mesh):

- ``verify_bls``: a batch of (pub, sig, H(msg)) triples, padded to a
  bucket (4, 128 or 512) and checked by the two kernels of
  ``ops/pairing.py``; larger batches run as several top-bucket launches
  and are read back once;
- ``verify_beacons``: V1 (chained) + V2 checks of a span of rounds
  (client/verify.go:146-163), routed as the JAX engine routes it: with
  the wire path on, the wire-RLC tier first and per-item ``verify_wire``
  when it returns None; with it off, one flattened ``verify_bls`` call;
- ``verify_wire``: (message bytes, compressed signature) checks with
  hashing, decompression and the subgroup check on the card (the kernels
  of ``ops/wire.py``): the host does only SHA-256 expansion and byte
  splitting (``ops/h2c.py``);
- ``verify_wire_rlc`` / ``verify_beacons_wire_rlc``: a span collapsed
  on the card to (Σcᵢσᵢ, ΣcᵢH(mᵢ)) with 128-bit random scalars — one MSM
  launch of both sums per bucket — and ONE product check of two Miller
  pairs;
- ``verify_sigs``: (msg, sig) pairs against one public key
  (chain/beacon/chain.go:141);
- ``verify_partials``: one round's partials against their share public
  keys, evaluated on the card by the Horner kernel (node.go:112);
- ``eval_poly_indices`` / ``eval_commits``: one commitment polynomial at
  many indices, or many polynomials at one index (the DKG deal check),
  on the Horner kernel of ``ops/eval.py``;
- ``recover``: Lagrange recovery of the group signature as one G2 MSM
  (``ops/msm.py``), GLS4-split by default (chain/beacon/chain.go:136);
- ``aggregate_round``: a node's whole round (chain.go:91-166) as one
  launch sequence — Horner for the share keys, MSM for the recovered
  signature, the recovered row spliced into the pairing batch on the
  card, K1, K2 — and one read-back.

Off the wire path, hashing to G2 and signature decompression run on the
host; decoding uses the ψ subgroup check (``crypto/endo.py``).
``wire_prep`` chooses: True always, False never, None (the default) for
spans of at least ``WIRE_MIN_CHECKS`` checks. The wire and wire-RLC
buckets are the engine's buckets: the JAX engine caps its wire buckets
at 128 (``WIRE_MAX_BUCKET``) because of the TPU's VMEM, which the card
does not share. ``device=None`` means
``cuda``; without CUDA the constructor raises — it never moves to the
CPU on its own. With ``device="cpu"`` the kernels' plain PyTorch
versions run (the tests).

Every shape passes a known-answer gate before first use (the JAX
engine's probes, all lanes must match); on failure the engine RAISES:
there is no fallback to the CPU or to the host oracle, and a failed
wire or wire-RLC gate, or a failed launch, is never swallowed into
another path (the JAX engine disables the shape or falls back to the
triples path there). What stays is the protocol's own tail: a chosen
partial that turns out invalid, or a round larger than the top bucket,
goes verify → filter → recover → verify; a combined RLC check that
fails, or a combination that degenerates to infinity, returns None and
the per-item wire path decides exactly — as in the JAX engine.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import metrics
from ..chain import beacon as chain_beacon
from ..crypto import batch_verify, bls, endo, tbls
from ..crypto.curves import PointG1, PointG2
from ..crypto.fields import P, R, Fp, Fp2
from ..crypto.hash_to_curve import DEFAULT_DST_G2, hash_to_g2
from ..crypto.poly import PriPoly, PubPoly, PubShare, lagrange_coefficients
from . import eval as horner_ops
from . import h2c as h2c_ops
from . import msm as msm_ops
from . import pairing, wire
from .curve import scalar_to_bits
from .limb import NWORDS, fp_from_words, fp_words

DEFAULT_BUCKETS = (4, 128, 512)
_MSG_CACHE_MAX = 4096
# index width of the Horner ladder: abscissae idx + 1 up to 2047 (the
# JAX engine's _EVAL_IDX_BITS)
EVAL_IDX_BITS = 11
# the Horner's lane buckets are the engine's buckets of at least this size
# (else 128), as the JAX engine's eval paths choose them
_EVAL_MIN_BUCKET = 32
FULL_SCALAR_BITS = 255
# auto wire mode: spans of at least this many checks take the wire path
# (the JAX engine's PALLAS_MIN_BUCKET)
WIRE_MIN_CHECKS = 32
# spans of at least this many checks try the wire-RLC tier first (the JAX
# engine's ENGINE_RLC_MIN; an instance attribute, rlc_min)
ENGINE_RLC_MIN = 8
RLC_NBITS = batch_verify.RLC_SCALAR_BITS
_PAD_MSG = b"drand-tpu-pad"


def _g1_xy(xy) -> np.ndarray:
    x, y = xy
    return np.stack([fp_words(x.v), fp_words(y.v)])


def _g2_xy(xy) -> np.ndarray:
    x, y = xy
    return np.stack([np.stack([fp_words(x.c0), fp_words(x.c1)]),
                     np.stack([fp_words(y.c0), fp_words(y.c1)])])


def _g2_from_words(xy: np.ndarray) -> PointG2:
    """(2, 2, 12) affine words -> host point."""
    return PointG2(Fp2(fp_from_words(xy[0, 0]), fp_from_words(xy[0, 1])),
                   Fp2(fp_from_words(xy[1, 0]), fp_from_words(xy[1, 1])),
                   Fp2.one())


def decode_sig(sig_bytes: bytes) -> PointG2 | None:
    """Wire signature -> subgroup-checked point, or None when it must be
    rejected: malformed, at infinity, or outside the order-r subgroup.
    The ψ check (``endo.subgroup_check_fast``) has the accept set of
    ``PointG2.from_bytes(subgroup_check=True)`` at about a third of the
    cost (``batch_verify.decode_sig`` of the JAX package)."""
    try:
        pt = PointG2.from_bytes(sig_bytes, subgroup_check=False)
    except ValueError:
        return None
    if pt.is_infinity() or not endo.subgroup_check_fast(pt):
        return None
    return pt


def _bucket_of(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _beacon_checks(beacons):
    """(message, signature bytes) checks of a span — V1, then V2 when
    present — and each beacon's (start, count) in them."""
    checks, spans = [], []
    for bcn in beacons:
        start = len(checks)
        checks.append((chain_beacon.message(bcn.round, bcn.previous_sig),
                       bcn.signature))
        if bcn.is_v2():
            checks.append((chain_beacon.message_v2(bcn.round),
                           bcn.signature_v2))
        spans.append((start, len(checks) - start))
    return checks, spans


def msm_lanes(t: int, gls4: bool) -> int:
    """MSM lanes of a t-share recovery: four digit lanes per share with
    GLS4, one otherwise, padded to a power of two of at least 8 (the
    JAX engine's ``agg_shape``)."""
    return max(8, 1 << ((4 * t if gls4 else t) - 1).bit_length())


class BatchedEngine:
    """Bucketed batch verifier and threshold-round engine on one device."""

    def __init__(self, device=None, buckets=DEFAULT_BUCKETS, gls4=True,
                 wire_prep: bool | None = None):
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
        self.eval_buckets = tuple(
            b for b in self.buckets if b >= _EVAL_MIN_BUCKET) or (128,)
        # GLS4 split of the recovery MSM: the JAX engine's policy off the
        # TPU (on), a constructor argument so the 255-bit packing stays
        # reachable
        self.gls4 = bool(gls4)
        # wire path: True always, False never, None for spans of at least
        # WIRE_MIN_CHECKS checks
        self.wire_prep = wire_prep
        self.rlc_min = ENGINE_RLC_MIN
        self._wire_ok: dict[int, bool] = {}
        self._wire_rlc_ok: dict[int, bool] = {}
        self._msg_cache: dict[tuple[bytes, bytes], PointG2] = {}
        self._bucket_ok: dict[int, bool] = {}
        self._agg_ok: dict[tuple[int, int, int], bool] = {}
        self._eval_ok: dict[tuple[int, int], bool] = {}
        self._poly_eval_ok: dict[tuple[int, int, bool], bool] = {}
        # host vs device seconds of the public calls, summed (hash =
        # hash-to-G2, decode = signature decompression + subgroup check,
        # prep = the wire path's SHA-256 expansion and byte splitting,
        # pack = affine conversion + word packing + host unpacking,
        # device = kernels and their read-back)
        self.stage_seconds = {"hash": 0.0, "decode": 0.0, "prep": 0.0,
                              "pack": 0.0, "device": 0.0}

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

    def _decode_partials(self, partials) -> list[PointG2 | None]:
        """Each partial's signature point, decoded once; None for a
        malformed or rejected partial."""
        return [self._decode_sig(p[tbls.INDEX_BYTES:])
                if len(p) == tbls.PARTIAL_SIG_SIZE else None
                for p in partials]

    def _to_device(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

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
        dev = self._to_device(pubs, sigs, msgs)
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
        return _bucket_of(n, self.buckets)

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
        present); per-beacon bools. On the wire path: the wire-RLC tier
        when the span reaches ``rlc_min``, and the per-item
        ``verify_wire`` when that returns None (``engine.py:846-875`` of
        the JAX package, without its silent fallback); off it, one
        flattened ``verify_bls`` call."""
        checks, spans = _beacon_checks(beacons)
        if self._use_wire(len(checks)):
            if self._rlc_wanted(len(checks)):
                got = self.verify_beacons_wire_rlc(pubkey, beacons, dst)
                if got is not None:
                    return got
            flat = self.verify_wire(pubkey, checks, dst)
        else:
            flat = self.verify_bls([(pubkey, self._decode_sig(sig),
                                     self._hash_msg(msg, dst))
                                    for msg, sig in checks])
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
        """All partials of one round against their share public keys,
        which come from ONE Horner launch over the commitment polynomial
        (``_share_pubkeys``); a malformed partial is False."""
        return self._verify_partials(pub_poly, msg, partials, dst,
                                     self._decode_partials(partials))

    def _verify_partials(self, pub_poly, msg, partials, dst, decoded):
        msg_pt = self._hash_msg(msg, dst)
        pubkeys = self._share_pubkeys(pub_poly, partials)
        triples = [(PointG1.generator(), None, msg_pt) if pk is None
                   else (pk, pt, msg_pt)
                   for pk, pt in zip(pubkeys, decoded)]
        return [bool(v) for v in self.verify_bls(triples)]

    # ----------------------------------------------------------- wire path
    def _use_wire(self, n_checks: int) -> bool:
        return (self.wire_prep if self.wire_prep is not None
                else n_checks >= WIRE_MIN_CHECKS)

    def _rlc_wanted(self, n_checks: int) -> bool:
        return n_checks >= self.rlc_min

    def wire_rlc_active(self, n_checks: int) -> bool:
        """True iff a span of ``n_checks`` wire checks takes the wire-RLC
        tier first (wire mode and the ``rlc_min`` floor)."""
        return bool(self._use_wire(n_checks)) and self._rlc_wanted(n_checks)

    def check_wire(self, n_checks: int) -> None:
        """Run every known-answer gate a span of ``n_checks`` wire checks
        can reach — the wire-RLC bucket, the combined row's verify bucket
        and the per-item wire bucket — so that a span after it launches
        only its own kernels. Raises on failure."""
        b = self._bucket(n_checks)
        if self._rlc_wanted(n_checks):
            self._check_wire_rlc(b)
            self.check_bucket(self._bucket(1))
        self.check_wire_bucket(b)

    def _wire_prep(self, checks, b: int, dst: bytes):
        """Host prep of one padded wire bucket: SHA-256 expansion of the
        messages and byte splitting of the signatures (pad rows: the pad
        message and the generator as signature) -> (u, xs, sign, valid)."""
        t0 = time.perf_counter()
        n = len(checks)
        u = h2c_ops.msgs_to_u([m for m, _ in checks] + [_PAD_MSG] * (b - n),
                              dst)
        xs, sign, valid = h2c_ops.sigs_to_x(
            [s for _, s in checks] + [h2c_ops.pad_sig()] * (b - n))
        self.stage_seconds["prep"] += time.perf_counter() - t0
        return u, xs, sign, valid

    def pack_wire_bucket(self, pubkey: PointG1, checks, b: int,
                         dst: bytes = DEFAULT_DST_G2):
        """Host arrays of one padded wire bucket: (pub (2, 12), u, xs,
        sign, valid, count, b); it can be dispatched any number of times
        (``dispatch_wire_packed``)."""
        return (_g1_xy(pubkey.to_affine()), *self._wire_prep(checks, b, dst),
                len(checks), b)

    def _wire_to_device(self, packed):
        pub, u, xs, sign = packed[:4]
        t0 = time.perf_counter()
        dev = self._to_device(pub, u, xs, sign.astype(np.int32))
        self.stage_seconds["pack"] += time.perf_counter() - t0
        return dev

    def dispatch_wire_packed(self, packed: list) -> np.ndarray:
        """Run packed wire buckets (K6, K5, K1, K2 each) with one
        read-back; the raw verdicts (len(packed), b), pad rows included.
        Every copy goes to the card before the first launch: a copy from
        pageable memory waits for the kernels queued before it."""
        devs = [self._wire_to_device(p) for p in packed]
        t0 = time.perf_counter()
        host = torch.stack([wire.verify_wire_prepared(*d)
                            for d in devs]).cpu().numpy()
        self.stage_seconds["device"] += time.perf_counter() - t0
        return host

    def check_wire_bucket(self, b: int) -> None:
        """Known-answer gate of wire bucket b, run once (the JAX engine's
        ``_check_wire_bucket``): row 0 must verify, row 1 must not, and no
        pad row (the generator over the pad message) may — all lanes.
        Raises on failure."""
        if self._wire_ok.get(b):
            return
        sk = 0x5A17
        pub = PointG1.generator().mul(sk)
        m = b"engine-wire-bucket-check"
        checks = [(m, bls.sign(sk, m)), (b"other-msg", bls.sign(sk, m))]
        packed = self.pack_wire_bucket(pub, checks, b)
        full = self.dispatch_wire_packed([packed])[0]
        ok = (bool(full[0]) and not bool(full[1])
              and not bool(full[2:].any()) and bool(packed[4][:2].all()))
        self._wire_ok[b] = ok
        if not ok:
            raise RuntimeError(
                f"BatchedEngine: wire bucket {b} failed its known-answer "
                f"test on {self.device}")

    def verify_wire(self, pubkey: PointG1, checks,
                    dst: bytes = DEFAULT_DST_G2) -> np.ndarray:
        """Batch-verify (message bytes, compressed signature) pairs against
        one public key, with hashing, decompression and the subgroup check
        on the card; the host does SHA-256 expansion and byte splitting.
        One bucket launch sequence per chunk, one read-back."""
        n = len(checks)
        if n == 0:
            return np.zeros(0, dtype=bool)
        if pubkey.is_infinity():
            return np.zeros(n, dtype=bool)
        b = self._bucket(n)
        self.check_wire_bucket(b)
        metrics.meter_rows(n)
        packed = [self.pack_wire_bucket(pubkey, checks[i:i + b], b, dst)
                  for i in range(0, n, b)]
        host = self.dispatch_wire_packed(packed)
        return np.concatenate([(host[j] & p[4])[:p[5]]
                               for j, p in enumerate(packed)])

    def _combine_wire_chunk(self, checks, cs, b: int, dst: bytes):
        """One wire-RLC combine of <= b checks: (ok mask, Σc·σ, Σc·H(m)) as
        host points; (mask, None, None) when no lane survives decoding;
        None when a live combination degenerates to infinity (the caller
        falls back; ~2^-128 for honest input). One read-back."""
        n = len(checks)
        u, xs, sign, valid = self._wire_prep(checks, b, dst)
        t0 = time.perf_counter()
        live = valid.copy()
        live[n:] = False
        bits = np.zeros((b, RLC_NBITS), np.int32)
        raw = b"".join(c.to_bytes(RLC_NBITS // 8, "big") for c in cs)
        bits[:n] = np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(
            n, RLC_NBITS)                        # MSB first
        dev = self._to_device(u, xs, sign.astype(np.int32),
                              live.astype(np.int32), bits)
        t1 = time.perf_counter()
        self.stage_seconds["pack"] += t1 - t0
        ok, (sxy, sinf), (mxy, minf) = wire.wire_rlc_combine(*dev)
        flat = torch.cat([ok.to(torch.int32), sxy.reshape(-1), sinf,
                          mxy.reshape(-1), minf]).cpu().numpy()
        self.stage_seconds["device"] += time.perf_counter() - t1
        w = 4 * NWORDS
        mask = flat[:b].astype(bool)[:n]
        if not mask.any():
            return mask, None, None
        if flat[b + w] or flat[b + 2 * w + 1]:
            return None
        return (mask, _g2_from_words(flat[b:b + w].reshape(2, 2, NWORDS)),
                _g2_from_words(flat[b + w + 1:b + 2 * w + 1].reshape(
                    2, 2, NWORDS)))

    def _check_wire_rlc(self, b: int) -> None:
        """Known-answer gate of the wire-RLC combine at bucket b, run once
        (the JAX engine's ``_wire_rlc_kat_probe``): two signatures and a
        malformed lane that must be left out, against the host MSM and
        ``hash_to_g2``. Raises on failure."""
        if self._wire_rlc_ok.get(b):
            return
        sk = 0x5A17
        m1, m2 = b"engine-wire-rlc-a", b"engine-wire-rlc-b"
        s1, s2 = bls.sign(sk, m1), bls.sign(sk, m2)
        checks, cs, expect_mask = [(m1, s1), (m2, s2)], [5, 7], [True, True]
        if b >= 3:
            checks.append((b"engine-wire-rlc-bad", b"\x00" * 96))
            cs.append(3)
            expect_mask.append(False)
        got = self._combine_wire_chunk(checks, cs, b, DEFAULT_DST_G2)
        ok = got is not None and got[1] is not None
        if ok:
            mask, s_comb, m_comb = got
            p1 = PointG2.from_bytes(s1, subgroup_check=False)
            p2 = PointG2.from_bytes(s2, subgroup_check=False)
            ok = (mask.tolist() == expect_mask
                  and s_comb == p1.mul(5) + p2.mul(7)
                  and m_comb == hash_to_g2(m1).mul(5)
                  + hash_to_g2(m2).mul(7))
        self._wire_rlc_ok[b] = ok
        if not ok:
            raise RuntimeError(
                f"BatchedEngine: wire-RLC bucket {b} failed its known-answer "
                f"test on {self.device}")

    def verify_wire_rlc(self, pubkey: PointG1, checks,
                        dst: bytes = DEFAULT_DST_G2) -> np.ndarray | None:
        """Per-check bools when the span's combined 2-pairing check holds
        (checks that fail decoding are False and left out of the
        combination), or None — a degenerate combination or a failed
        combined check — for the caller to decide per item. Spans above
        the bucket combine chunk by chunk under one scalar vector; the
        chunk sums are added on the host and checked as ONE row."""
        n = len(checks)
        if n == 0:
            return np.zeros(0, dtype=bool)
        if pubkey.is_infinity():
            return None
        b = self._bucket(n)
        self._check_wire_rlc(b)
        cs = batch_verify.rlc_scalars(n)
        ok_mask = np.zeros(n, dtype=bool)
        s_acc = m_acc = None
        for lo in range(0, n, b):
            hi = min(lo + b, n)
            got = self._combine_wire_chunk(checks[lo:hi], cs[lo:hi], b, dst)
            if got is None:
                return None
            ok_chunk, s_chunk, m_chunk = got
            ok_mask[lo:hi] = ok_chunk
            if s_chunk is not None:
                s_acc = s_chunk if s_acc is None else s_acc + s_chunk
                m_acc = m_chunk if m_acc is None else m_acc + m_chunk
        if s_acc is None:
            return ok_mask          # nothing decodable: every check False
        if s_acc.is_infinity() or m_acc.is_infinity():
            return None
        if bool(self.verify_bls([(pubkey, s_acc, m_acc)])[0]):
            return ok_mask
        return None

    def verify_beacons_wire_rlc(self, pubkey: PointG1, beacons,
                                dst: bytes = DEFAULT_DST_G2
                                ) -> np.ndarray | None:
        """A span of beacons through the wire-RLC tier: per-beacon bools,
        or None for the caller to decide per item."""
        checks, spans = _beacon_checks(beacons)
        flat = self.verify_wire_rlc(pubkey, checks, dst)
        if flat is None:
            return None
        return np.array([bool(flat[s:s + c].all()) for s, c in spans],
                        dtype=bool)

    # ---------------------------------------------- commitment evaluation
    def _eval_bucket(self, n: int) -> int:
        return _bucket_of(n, self.eval_buckets)

    @staticmethod
    def _check_index(index: int) -> None:
        if not 0 <= index + 1 < (1 << EVAL_IDX_BITS):
            raise ValueError("index out of range")

    def _poly_commit_words(self, pub_poly: PubPoly, b: int) -> torch.Tensor:
        """(t, b, 2, 12) device commitments: one polynomial on b lanes."""
        flat = PointG1.batch_to_affine(pub_poly.commits)
        words = np.stack([_g1_xy(xy) for xy in flat])[:, None]
        (dev,) = self._to_device(np.broadcast_to(
            words, (len(flat), b, 2, NWORDS)))
        return dev

    def _index_bits(self, indices, b: int) -> torch.Tensor:
        """(b, 11) device bits of idx + 1 per lane; pad lanes hold 0."""
        bits = np.zeros((b, EVAL_IDX_BITS), np.int32)
        for j, idx in enumerate(indices):
            bits[j] = scalar_to_bits(idx + 1, EVAL_IDX_BITS)
        (dev,) = self._to_device(bits)
        return dev

    def eval_poly_indices(self, pub_poly: PubPoly,
                          indices: list[int]) -> list[PointG1]:
        """ONE polynomial at MANY indices (the share public keys of a
        group): the commitments on every lane, each lane's own index
        bits, one Horner launch per bucket and one read-back."""
        n = len(indices)
        if n == 0:
            return []
        for i in indices:
            self._check_index(i)
        if any(c.is_infinity() for c in pub_poly.commits):
            # no affine packing for an infinite commitment (a legal wire
            # encoding): the protocol's host evaluation
            return [pub_poly.eval(i).value for i in indices]
        t = len(pub_poly.commits)
        b = self._eval_bucket(n)
        self._check_poly_eval_bucket(t, b, affine=False)
        t0 = time.perf_counter()
        commits = self._poly_commit_words(pub_poly, b)
        bits = [self._index_bits(indices[s:s + b], b) for s in range(0, n, b)]
        t1 = time.perf_counter()
        self.stage_seconds["pack"] += t1 - t0
        return self._read_evals([horner_ops.horner(commits, lb)
                                 for lb in bits], n, t1)

    def _read_evals(self, outs, n: int, t0: float) -> list[PointG1]:
        """One read-back of Horner outputs -> host points."""
        rows = torch.cat([torch.cat([xyz.reshape(xyz.shape[0], -1),
                                     inf[:, None]], dim=1)
                          for xyz, inf in outs]).cpu().numpy()
        t1 = time.perf_counter()
        self.stage_seconds["device"] += t1 - t0
        out = self._unpack_eval_host(rows[:, :-1].reshape(-1, 3, NWORDS),
                                     rows[:, -1], n)
        self.stage_seconds["pack"] += time.perf_counter() - t1
        return out

    def _check_poly_eval_bucket(self, t: int, b: int, affine: bool) -> None:
        """Known-answer gate of the many-indices Horner at (t, b), in the
        output form used (Jacobian, or normalised to Z = 1 for the fused
        round); raises on failure."""
        key = (t, b, affine)
        if self._poly_eval_ok.get(key):
            return
        g = PointG1.generator()
        poly = PubPoly([g.mul(1 + k) for k in range(t)])
        probe = [0, 3, 7][:min(3, b)]
        xyz, inf = horner_ops.horner(self._poly_commit_words(poly, b),
                                     self._index_bits(probe, b), affine)
        xyz, inf = xyz.cpu().numpy(), inf.cpu().numpy()
        got = self._unpack_eval_host(xyz, inf, len(probe))
        ok = got == [poly.eval(i).value for i in probe]
        if affine:
            ok = ok and all(fp_from_words(z) == 1 for z in xyz[:, 2])
        self._poly_eval_ok[key] = ok
        if not ok:
            raise RuntimeError(
                f"BatchedEngine: Horner (t={t}, b={b}, affine={affine}) "
                f"failed its known-answer test on {self.device}")

    def eval_commits(self, polys, index: int) -> list[PointG1]:
        """MANY polynomials at ONE index — the DKG deal check (reference
        kyber vss: one evaluation per dealer): a dealer per lane, the
        index broadcast, one Horner launch per bucket, one read-back."""
        n = len(polys)
        if n == 0:
            return []
        t = len(polys[0].commits)
        if any(len(p.commits) != t for p in polys):
            raise ValueError("mixed commitment lengths")
        self._check_index(index)
        # a polynomial with an infinite commitment (a legal wire encoding
        # a malicious dealer can ship) has no affine packing: the
        # protocol's host evaluation for those, the card for the rest
        bad = {i for i, p in enumerate(polys)
               if any(c.is_infinity() for c in p.commits)}
        if bad:
            dev = iter(self.eval_commits(
                [p for i, p in enumerate(polys) if i not in bad], index))
            return [polys[i].eval(index).value if i in bad else next(dev)
                    for i in range(n)]
        b = self._eval_bucket(n)
        self._check_eval_bucket(t, b)
        t0 = time.perf_counter()
        packed = [self._pack_eval_bucket(polys[s:s + b], index, b)
                  for s in range(0, n, b)]
        t1 = time.perf_counter()
        self.stage_seconds["pack"] += t1 - t0
        return self._read_evals([horner_ops.horner(*a) for a in packed], n,
                                t1)

    def _pack_eval_bucket(self, polys, index: int, b: int):
        """Device inputs of one bucket: every dealer's commitments on its
        lane (generator pads), the index bits broadcast."""
        t = len(polys[0].commits)
        gen = _g1_xy(PointG1.generator().to_affine())
        com = np.empty((t, b, 2, NWORDS), np.int32)
        com[:] = gen
        flat = PointG1.batch_to_affine(
            [c for poly in polys for c in poly.commits])
        for d in range(len(polys)):
            for k in range(t):
                com[k, d] = _g1_xy(flat[d * t + k])
        bits = np.broadcast_to(scalar_to_bits(index + 1, EVAL_IDX_BITS),
                               (b, EVAL_IDX_BITS))
        return self._to_device(com, bits)

    def _check_eval_bucket(self, t: int, b: int) -> None:
        """Known-answer gate of the one-index Horner at (t, b): three
        dealers against the host, then every lane on constant generator
        polynomials (eval = [Σ (index+1)^k]·g). Raises on failure."""
        key = (t, b)
        if self._eval_ok.get(key):
            return
        g = PointG1.generator()
        polys = [PubPoly([g.mul(1 + 31 * d + k) for k in range(t)])
                 for d in range(min(3, b))]
        index = 5
        got = self._run_eval_bucket(polys, index, b)
        ok = got == [p.eval(index).value for p in polys]
        if ok and b > len(polys):
            pad = g.mul(sum((index + 1) ** k for k in range(t)))
            ok = all(p == pad for p in self._run_eval_bucket(
                [PubPoly([g] * t)] * b, index, b))
        self._eval_ok[key] = ok
        if not ok:
            raise RuntimeError(
                f"BatchedEngine: Horner (t={t}, b={b}) failed its "
                f"known-answer test on {self.device}")

    def _run_eval_bucket(self, polys, index: int, b: int) -> list[PointG1]:
        xyz, inf = horner_ops.horner(*self._pack_eval_bucket(polys, index, b))
        return self._unpack_eval_host(xyz.cpu().numpy(), inf.cpu().numpy(),
                                      len(polys))

    @staticmethod
    def _unpack_eval_host(xyz, inf, n: int) -> list[PointG1]:
        """Jacobian Horner rows (n, 3, 12) words + inf flags -> host
        points, with ONE Montgomery batch inversion for the whole bucket
        (``BatchedEngine._unpack_eval_host`` of the JAX package)."""
        xs = [fp_from_words(xyz[d, 0]) for d in range(n)]
        ys = [fp_from_words(xyz[d, 1]) for d in range(n)]
        zs = [fp_from_words(xyz[d, 2]) for d in range(n)]
        zz = [1 if inf[d] else (zs[d] or 1) for d in range(n)]
        pref = [1] * (n + 1)
        for i, z in enumerate(zz):
            pref[i + 1] = pref[i] * z % P
        acc = pow(pref[n], P - 2, P)
        invs = [0] * n
        for i in range(n - 1, -1, -1):
            invs[i] = acc * pref[i] % P
            acc = acc * zz[i] % P
        out = []
        for d in range(n):
            if inf[d] or zs[d] == 0:
                out.append(PointG1.infinity())
                continue
            zi = invs[d]
            zi2 = zi * zi % P
            out.append(PointG1(Fp(xs[d] * zi2 % P),
                               Fp(ys[d] * zi2 % P * zi % P), Fp(1)))
        return out

    def _share_pubkeys(self, pub_poly: PubPoly, partials):
        """Per-partial share public keys, those not yet in the
        polynomial's cache from ONE ``eval_poly_indices`` call; None for
        a malformed partial. A device error raises."""
        idxs = sorted({tbls.index_of(p) for p in partials
                       if len(p) == tbls.PARTIAL_SIG_SIZE})
        need = [i for i in idxs if i not in pub_poly._eval_cache
                and 0 <= i + 1 < (1 << EVAL_IDX_BITS)]
        if need:
            for i, v in zip(need, self.eval_poly_indices(pub_poly, need)):
                pub_poly._eval_cache[i] = PubShare(i, v)
        return [pub_poly.eval(tbls.index_of(p)).value
                if len(p) == tbls.PARTIAL_SIG_SIZE else None
                for p in partials]

    # ------------------------------------------------------------ recover
    @staticmethod
    def _select_shares(partials, t: int, n: int,
                       decoded=None) -> list[PubShare]:
        """First t distinct well-formed indices win — the tbls.recover
        selection semantics, shared by recover and the fused round.
        ``decoded``: the partials' points, already decoded once."""
        shares: list[PubShare] = []
        seen: set[int] = set()
        for j, p in enumerate(partials):
            if len(p) != tbls.PARTIAL_SIG_SIZE:
                continue
            idx = tbls.index_of(p)
            if idx in seen or idx >= n:
                continue
            pt = (decode_sig(p[tbls.INDEX_BYTES:]) if decoded is None
                  else decoded[j])
            if pt is None:
                continue
            seen.add(idx)
            shares.append(PubShare(idx, pt))
            if len(shares) == t:
                break
        return shares

    def _gls4_active(self, t: int) -> bool:
        """GLS ψ² 4-D split of a t-share recovery MSM: the JAX engine's
        policy off the TPU, where no fixed lane width limits it."""
        return self.gls4

    @staticmethod
    def _pack_msm_gls4(shares, lambdas, b: int):
        """GLS-split MSM packing: each share expands to its four ψ-basis
        lanes (P, −ψP, ψ²P, −ψ³P) with the base-M digits of its Lagrange
        coefficient as 64-bit scalars. Returns (pts (b, 2, 2, 12), inf
        (b,) bool, bits (b, 64)); pad and zero-digit lanes are masked."""
        pad = _g2_xy(PointG2.generator().to_affine())
        pts = np.broadcast_to(pad, (b, 2, 2, NWORDS)).copy()
        inf = np.ones(b, dtype=bool)
        nbits = endo.GLS4_DIGIT_BITS
        bits = np.zeros((b, nbits), np.int32)
        share_xy = PointG2.batch_to_affine([s.value for s in shares])
        for i, s in enumerate(shares):
            digits = endo.gls4_decompose(lambdas[s.index] % R)
            basis = endo.gls4_points_from_affine(*share_xy[i])
            for k, d in enumerate(digits):
                lane = 4 * i + k
                if not d:
                    continue
                pts[lane] = _g2_xy((basis[k].X, basis[k].Y))  # Z == 1
                inf[lane] = False
                bits[lane] = scalar_to_bits(d, nbits)
        return pts, inf, bits

    @staticmethod
    def _pack_msm_full(shares, lambdas, b: int):
        """One lane per share with its full 255-bit Lagrange coefficient;
        same outputs as ``_pack_msm_gls4``."""
        pad = _g2_xy(PointG2.generator().to_affine())
        pts = np.broadcast_to(pad, (b, 2, 2, NWORDS)).copy()
        inf = np.ones(b, dtype=bool)
        bits = np.zeros((b, FULL_SCALAR_BITS), np.int32)
        share_xy = PointG2.batch_to_affine([s.value for s in shares])
        for i, s in enumerate(shares):
            pts[i] = _g2_xy(share_xy[i])
            inf[i] = False
            bits[i] = scalar_to_bits(lambdas[s.index] % R, FULL_SCALAR_BITS)
        return pts, inf, bits

    def _msm_inputs(self, shares, gls4: bool, b: int):
        """The device inputs (pts, mask, bits) of the Lagrange MSM of
        ``shares`` on b lanes."""
        t0 = time.perf_counter()
        lambdas = lagrange_coefficients([s.index for s in shares])
        pack = self._pack_msm_gls4 if gls4 else self._pack_msm_full
        pts, inf, bits = pack(shares, lambdas, b)
        dev = self._to_device(pts, inf.astype(np.int32), bits)
        self.stage_seconds["pack"] += time.perf_counter() - t0
        return dev

    def recover(self, pub_poly: PubPoly, msg: bytes, partials, t: int, n: int,
                dst: bytes = DEFAULT_DST_G2, *, shares=None) -> bytes:
        """Lagrange-recover the full signature on the card: one G2 MSM
        with the Lagrange coefficients as scalars (Scheme.Recover,
        chain/beacon/chain.go:136), GLS4-split when ``self.gls4``. Same
        selection as the host ``tbls.recover``: the first t distinct
        valid indices win. ``shares``: pre-selected PubShares."""
        if shares is None:
            shares = self._select_shares(partials, t, n,
                                         self._decode_partials(partials))
        if len(shares) < t:
            raise ValueError(f"not enough valid partials: {len(shares)} < {t}")
        gls4 = self._gls4_active(len(shares))
        inputs = self._msm_inputs(shares, gls4, msm_lanes(len(shares), gls4))
        t0 = time.perf_counter()
        xy, inf = msm_ops.msm(*inputs)
        host = torch.cat([xy.reshape(-1), inf]).cpu().numpy()
        self.stage_seconds["device"] += time.perf_counter() - t0
        if host[-1]:
            raise ValueError("recovered signature is the point at infinity")
        return _g2_from_words(host[:-1].reshape(2, 2, NWORDS)).to_bytes()

    # ------------------------------------------- fused aggregator round
    def agg_shape(self, npart: int, t: int) -> tuple[int, int, int]:
        """(pairing bucket, MSM lanes, MSM scalar bits) of the fused
        round — the key of its known-answer gate."""
        gls4 = self._gls4_active(t)
        return (self._bucket(npart + 1), msm_lanes(t, gls4),
                endo.GLS4_DIGIT_BITS if gls4 else FULL_SCALAR_BITS)

    def agg_fused_active(self, npart: int, t: int) -> bool:
        """True iff an (npart, t) aggregate_round runs the fused launch
        sequence (its gate passed) rather than the classic path."""
        return bool(self._agg_ok.get(self.agg_shape(npart, t)))

    def check_round(self, npart: int, t: int) -> None:
        """Run every known-answer gate an (npart, t) aggregate_round can
        reach — the fused shape, its Horner, and the verify buckets of
        the classic tail — so that a round after it launches only its own
        kernels. Raises on failure."""
        b, b_msm, nbits = self.agg_shape(npart, t)
        b_eval = self._eval_bucket(npart)
        if npart + 1 <= b:
            self._check_agg_bucket(b, b_msm, nbits)
            self._check_poly_eval_bucket(t, b_eval, affine=True)
        else:                      # verify -> filter -> recover -> verify
            self.check_bucket(self._bucket(npart))
            self._check_poly_eval_bucket(t, b_eval, affine=False)
        self.check_bucket(self._bucket(1))   # the tail's verify_sigs

    def _check_agg_bucket(self, b: int, b_msm: int, nbits: int) -> None:
        """Known-answer gate of the fused round at (bucket, MSM lanes,
        MSM bits): a 2-of-3 toy group whose verdicts and recovered
        signature are known on the host, packed as the dispatch packs
        (GLS4 digit lanes or full width). Raises on failure."""
        key = (b, b_msm, nbits)
        if self._agg_ok.get(key):
            return
        poly = PriPoly.random(2, seed=b"engine-agg-kat")
        pub_poly = poly.commit()
        msg = b"engine-agg-bucket-check"
        parts = [tbls.sign_partial(s, msg) for s in poly.shares(3)]
        bad = parts[2][:tbls.INDEX_BYTES] + parts[1][tbls.INDEX_BYTES:]
        expect_sig = tbls.recover(pub_poly, msg, parts[:2], 2, 3)
        oks, rec = self._run_agg(pub_poly, msg, parts[:2] + [bad], 2, 3,
                                 DEFAULT_DST_G2, b, b_msm,
                                 gls4=nbits != FULL_SCALAR_BITS)
        ok = oks == [True, True, False] and rec == expect_sig
        self._agg_ok[key] = ok
        if not ok:
            raise RuntimeError(
                f"BatchedEngine: fused round (bucket {b}, {b_msm} MSM lanes "
                f"of {nbits} bits) failed its known-answer test on "
                f"{self.device}")

    def aggregate_round(self, pub_poly: PubPoly, msg: bytes, partials,
                        t: int, n: int, dst: bytes = DEFAULT_DST_G2):
        """Verify all partials, Lagrange-recover and verify the recovered
        signature in ONE launch sequence with one read-back — a node's
        per-round work (chain/beacon/chain.go:91-166).

        Returns ``(oks, sig_bytes)`` with ``oks`` aligned to ``partials``.
        Optimistic: recovery uses the first ``t`` well-formed distinct
        indices (tbls.recover selection); if one of those turns out
        invalid, or the recovered signature fails, the classic tail
        recovers from the verified partials and verifies the result.
        A round larger than the top bucket takes verify → filter →
        recover → verify. Raises ``ValueError`` when fewer than ``t``
        well-formed partials exist."""
        npart = len(partials)
        decoded = self._decode_partials(partials)
        shares = self._select_shares(partials, t, n, decoded)
        if len(shares) < t:
            raise ValueError(f"not enough valid partials: {len(shares)} < {t}")
        b, b_msm, nbits = self.agg_shape(npart, t)
        if npart + 1 > b:
            oks = self._verify_partials(pub_poly, msg, partials, dst, decoded)
            return oks, self._recover_verified(pub_poly, msg, partials, oks,
                                               t, n, dst, decoded)
        self._check_agg_bucket(b, b_msm, nbits)
        metrics.meter_rows(npart + 1)
        oks, rec = self._run_agg(pub_poly, msg, partials, t, n, dst, b, b_msm,
                                 shares=shares, decoded=decoded,
                                 gls4=nbits != FULL_SCALAR_BITS)
        chosen = {s.index for s in shares}
        chosen_ok = all(ok for p, ok in zip(partials, oks)
                        if len(p) == tbls.PARTIAL_SIG_SIZE
                        and tbls.index_of(p) in chosen)
        if rec is not None and chosen_ok:
            return oks, rec
        return oks, self._recover_verified(pub_poly, msg, partials, oks,
                                           t, n, dst, decoded)

    def _recover_verified(self, pub_poly, msg, partials, oks, t, n, dst,
                          decoded):
        """Classic tail: recover from the partials that verified, then
        check the recovered signature."""
        good = [j for j, ok in enumerate(oks) if ok]
        if len(good) < t:
            raise ValueError(f"not enough valid partials: {len(good)} < {t}")
        shares = self._select_shares([partials[j] for j in good], t, n,
                                     [decoded[j] for j in good])
        sig = self.recover(pub_poly, msg, None, t, n, dst, shares=shares)
        if self.verify_sigs(pub_poly.commit(), [(msg, sig)], dst) != [True]:
            raise tbls.RecoveredSignatureInvalid(
                "recovered signature failed verification")
        return sig

    def _run_agg(self, pub_poly, msg, partials, t, n, dst, b, b_msm,
                 shares=None, gls4=None, decoded=None):
        """Pack, launch and read back one fused round; returns (oks, sig
        bytes, or None when the recovered row failed or is infinity).

        Launch sequence: the Horner (normalised to Z = 1) for share keys
        not yet cached, the MSM, the recovered row spliced at the slot
        row on the card, K1, K2; then ONE read-back of the verdicts, the
        recovered point and the new share keys."""
        npart = len(partials)
        msg_pt = self._hash_msg(msg, dst)
        if decoded is None:
            decoded = self._decode_partials(partials)
        if shares is None:
            shares = self._select_shares(partials, t, n, decoded)
        if gls4 is None:
            gls4 = self._gls4_active(len(shares))
        t0 = time.perf_counter()
        idx = [tbls.index_of(p) if len(p) == tbls.PARTIAL_SIG_SIZE else None
               for p in partials]
        on_card = not any(c.is_infinity() for c in pub_poly.commits)
        need = sorted({i for i in idx if i is not None
                       and i not in pub_poly._eval_cache
                       and 0 <= i + 1 < (1 << EVAL_IDX_BITS)}) \
            if on_card else []
        lane_of = {i: j for j, i in enumerate(need)}
        keys = {i: pub_poly.eval(i).value for i in set(idx)
                if i is not None and i not in lane_of}

        # pairing batch: rows 0..npart-1 the partials, row npart the
        # recovered signature against the group key. Rows whose key comes
        # from the Horner and the slot row's signature hold the generator
        # until the card overwrites them.
        triples, key_rows, key_lanes = [], [], []
        for j, (i, pt) in enumerate(zip(idx, decoded)):
            if i in lane_of:
                key_rows.append(j)
                key_lanes.append(lane_of[i])
            triples.append((keys.get(i, PointG1.generator()), pt, msg_pt))
        slot = npart
        triples.append((pub_poly.commit(), PointG2.generator(), msg_pt))
        slot_mask = np.zeros(b, dtype=bool)
        slot_mask[slot] = True
        (slot_d,) = self._to_device(slot_mask)
        self.stage_seconds["pack"] += time.perf_counter() - t0
        (pubs_d, sigs_d, msgs_d), valid, _ = self._pack_bucket(triples, b)

        b_eval = self._eval_bucket(len(need))
        if need:
            self._check_poly_eval_bucket(len(pub_poly.commits), b_eval,
                                         affine=True)
            tp = time.perf_counter()
            commits = self._poly_commit_words(pub_poly, b_eval)
            bits = [self._index_bits(need[s:s + b_eval], b_eval)
                    for s in range(0, len(need), b_eval)]
            r_d, l_d = self._to_device(np.array(key_rows, np.int64),
                                       np.array(key_lanes, np.int64))
            self.stage_seconds["pack"] += time.perf_counter() - tp
        msm_in = self._msm_inputs(shares, gls4, b_msm)
        t1 = time.perf_counter()
        tail = []
        if need:
            outs = [horner_ops.horner(commits, lb, affine=True) for lb in bits]
            kxyz = torch.cat([o[0] for o in outs])
            kinf = torch.cat([o[1] for o in outs])
            pubs_d[r_d] = kxyz[l_d, :2]
            tail = [kxyz[:len(need), :2].reshape(-1), kinf[:len(need)]]
        rxy, rinf = msm_ops.msm(*msm_in)
        sig_full = torch.where(slot_d[:, None, None, None], rxy[None], sigs_d)
        ok = pairing.verify_prepared(pubs_d, sig_full, msgs_d)
        ok = ok & (~slot_d | (rinf == 0))
        flat = torch.cat([ok.to(torch.int32), rxy.reshape(-1), rinf,
                          *tail]).cpu().numpy()
        t2 = time.perf_counter()
        self.stage_seconds["device"] += t2 - t1

        rec_words = flat[b:b + 4 * NWORDS].reshape(2, 2, NWORDS)
        rec_inf = bool(flat[b + 4 * NWORDS])
        if need:
            kw = flat[b + 4 * NWORDS + 1:]
            m = len(need)
            kxy = kw[:m * 2 * NWORDS].reshape(m, 2, NWORDS)
            for i, (xy, kinf_i) in enumerate(zip(kxy, kw[m * 2 * NWORDS:])):
                pub_poly._eval_cache[need[i]] = PubShare(
                    need[i], PointG1.infinity() if kinf_i else
                    PointG1(Fp(fp_from_words(xy[0])),
                            Fp(fp_from_words(xy[1])), Fp(1)))
            for j, lane in zip(key_rows, key_lanes):
                valid[j] &= not kw[m * 2 * NWORDS + lane]
        ok_host = flat[:b].astype(bool) & valid
        oks = [bool(v) for v in ok_host[:npart]]
        # valid[slot] is False only for an infinite group key
        sig = None if rec_inf or not (flat[slot] and valid[slot]) else \
            _g2_from_words(rec_words).to_bytes()
        self.stage_seconds["pack"] += time.perf_counter() - t2
        return oks, sig

    # ------------------------------------------------------- introspection
    def introspect(self) -> dict:
        """JSON-ready state: device, buckets and the per-shape gate
        verdicts (shapes not listed were never dispatched)."""
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {
            "backend": self.device.type,
            "devices": [name],
            "buckets": list(self.buckets),
            "wire_buckets": list(self.buckets),
            "wire_prep": self.wire_prep,
            "rlc_min": self.rlc_min,
            "gls4": self.gls4,
            "kat": {
                "verify": {str(b): ok for b, ok
                           in sorted(self._bucket_ok.items())},
                "wire": {str(b): ok for b, ok
                         in sorted(self._wire_ok.items())},
                "wire_rlc": {str(b): ok for b, ok
                             in sorted(self._wire_rlc_ok.items())},
                "agg": {str(k): ok for k, ok in sorted(self._agg_ok.items())},
                "eval": {str(k): ok for k, ok
                         in sorted(self._eval_ok.items())},
                "poly_eval": {str(k): ok for k, ok
                              in sorted(self._poly_eval_ok.items())},
            },
            "stage_seconds": dict(self.stage_seconds),
        }
