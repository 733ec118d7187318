"""Carry the JAX package's state across to the port.

The JAX package packs an Fp element as 32 int32 limbs of 12 bits,
little-endian, Montgomery form with R = 2^384, lazily reduced: limbs may
exceed 12 bits and the value may lie anywhere in [0, ~2^384)
(``drand_tpu/ops/limb.py:16-22``). The port keeps the same Montgomery
integer mod p as 12 canonical 32-bit words (``ops/limb.py``). The
functions here take plain numpy arrays and objects with ``to_bytes()``,
so this module needs nothing of the JAX package itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.curves import PointG1
from ..crypto.fields import P
from ..crypto.poly import PubPoly
from .limb import NWORDS, int_to_words, words_to_int

JAX_BITS = 12
JAX_NLIMBS = 32


def from_jax_limbs(a) -> torch.Tensor:
    """(..., 32) int32 JAX limbs (any lazily reduced value) -> (..., 12)
    int32 canonical words of the same Montgomery value mod p."""
    arr = np.asarray(a)
    if arr.shape[-1] != JAX_NLIMBS:
        raise ValueError(f"trailing axis {arr.shape[-1]}, expected 32")
    rows = arr.reshape(-1, JAX_NLIMBS).astype(np.int64)
    out = np.zeros((rows.shape[0], NWORDS), dtype=np.int32)
    for i, row in enumerate(rows.tolist()):
        v = sum(int(x) << (JAX_BITS * k) for k, x in enumerate(row))
        out[i] = int_to_words(v % P)
    return torch.from_numpy(out.reshape(arr.shape[:-1] + (NWORDS,)))


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """(..., 12) canonical words -> (..., 32) int32 canonical JAX limbs."""
    arr = t.detach().cpu().numpy()
    rows = arr.reshape(-1, NWORDS)
    out = np.zeros((rows.shape[0], JAX_NLIMBS), dtype=np.int32)
    mask = (1 << JAX_BITS) - 1
    for i, row in enumerate(rows):
        v = words_to_int(row)
        out[i] = [(v >> (JAX_BITS * k)) & mask for k in range(JAX_NLIMBS)]
    return out.reshape(arr.shape[:-1] + (JAX_NLIMBS,))


def _lead(x) -> torch.Tensor:
    """A batch-last JAX array (..., 32, B) -> port words (B, ..., 12)."""
    return from_jax_limbs(np.moveaxis(np.asarray(x), -1, 0))


def verify_inputs_from_jax(xp, yp, q):
    """``pallas_pairing.pack_verify_inputs`` output — xp, yp (2, 32, B),
    q (2, 2, 2, 32, B) — as the port's kernel inputs xp, yp (B, 2, 12)
    and q (B, 2, 2, 2, 12)."""
    return _lead(xp), _lead(yp), _lead(q)


def f12_from_jax(f) -> torch.Tensor:
    """A batch-last JAX Fp12 (2, 3, 2, 32, B) -> (B, 2, 3, 2, 12)."""
    return _lead(f)


def engine_batch_from_jax(pub_aff, sig_aff, msg_aff):
    """The JAX engine's packed bucket (``ops/engine.py:786-788``): pub
    (B, 2, 32), sig/msg (B, 2, 2, 32) -> the port's (B, 2, 12) and
    (B, 2, 2, 12) words, as ``ops.pairing.verify_prepared`` takes them."""
    return (from_jax_limbs(pub_aff), from_jax_limbs(sig_aff),
            from_jax_limbs(msg_aff))


def g1_from_jax(point) -> PointG1:
    """A G1 point of the JAX package (a group public key) -> the port's."""
    return PointG1.from_bytes(point.to_bytes())


def pub_poly_from_jax(pub_poly) -> PubPoly:
    """A ``PubPoly`` of the JAX package -> the port's, commit by commit."""
    return PubPoly([g1_from_jax(c) for c in pub_poly.commits])


def msm_inputs_from_jax(pts, inf, bits):
    """The JAX engine's MSM packing (``BatchedEngine._pack_msm_gls4`` and
    the full-width packing of ``recover``): pts (b, 2, 2, 32) limbs, inf
    (b,) bool (True = lane left out), bits (b, nbits) — as the inputs of
    the port's ``ops.msm.msm``: pts (b, 2, 2, 12) words, mask (b,) int32,
    bits (b, nbits) int32."""
    return (from_jax_limbs(pts),
            torch.from_numpy(np.asarray(inf).astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(bits, dtype=np.int32)))


def eval_inputs_from_jax(xs, ys, bits):
    """The JAX engine's Horner inputs: commitment limbs xs, ys (t, b, 32)
    and the index bits, shared (nbits,) (``eval_commits``) or per lane
    (b, nbits) (``eval_poly_indices``) — as the port's ``ops.eval.horner``
    inputs: commits (t, b, 2, 12) words and per-lane bits (b, nbits)."""
    commits = torch.stack([from_jax_limbs(xs), from_jax_limbs(ys)], dim=2)
    bits = np.asarray(bits, dtype=np.int32)
    if bits.ndim == 1:
        bits = np.broadcast_to(bits, (commits.shape[1], bits.shape[0]))
    return (commits.contiguous(),
            torch.from_numpy(np.ascontiguousarray(bits)))


def eval_rows_to_jax(xyz, inf) -> np.ndarray:
    """The port's Horner output, xyz (b, 3, 12) words and inf (b,), as the
    JAX engine's packed Jacobian eval rows (b, 3·32 + 1) that its
    ``BatchedEngine._unpack_eval_host`` reads."""
    xyz = torch.as_tensor(xyz)
    limbs = to_jax_limbs(xyz).reshape(xyz.shape[0], 3 * JAX_NLIMBS)
    flags = np.asarray(inf).astype(np.int32)[:, None]
    return np.concatenate([limbs, flags], axis=1)
