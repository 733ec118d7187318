"""G2 multi-scalar multiplication on the card: the kernels of
``csrc/msm.cu``, their wrapper with its launch counter, and their plain
PyTorch version.

Counterpart of the JAX package's ``ops/pallas_msm.py`` (``_msm_kernel``,
``msm_fold_bl``, ``msm_g2_bl``, ``msm_g2_pl``): Σ bitsᵢ·Pᵢ over G2, the
Lagrange recovery of a threshold signature. ``msm`` given CPU tensors
runs ``msm_plain``; given CUDA tensors it launches the kernels or raises.

Layouts (int32 words of canonical Montgomery values, ``ops/limb.py``):

    pts   (b, 2, 2, 12)   affine x / y of each lane's point, c0 / c1
    mask  (b,)            int32, nonzero: the lane is left out
    bits  (b, nbits)      int32 0/1, MSB first (nbits 64 for the GLS4
                          digit packing, 255 for full scalars)
    xy    (2, 2, 12)      affine sum (zeros when it is infinity)
    inf   (1,)            int32, 1 iff the sum is infinity

One call of ``msm`` on the card is two launches (the per-block ladder and
fold, then the fold of the block partials and the to-affine); it counts
as ONE in ``LAUNCHES["msm"]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import curve as cv
from .limb import NWORDS, halves_to_words, words_to_halves
from .pairing import _check, _consts_on, _ptr, _raise_on

# Launches of the MSM on the card (plain int; counted where launched).
LAUNCHES = {"msm": 0}

XY_SHAPE = (2, 2, NWORDS)


def msm_plain(pts: torch.Tensor, mask: torch.Tensor, bits: torch.Tensor):
    """Plain version: per-lane ladders (``pt_mul_bits``), a log-tree fold
    and the to-affine, on any device. Returns (xy, inf). ``pts`` may carry
    leading axes before the lane axis (several MSMs over the same mask and
    bits in one call); the outputs then carry them too."""
    xh = words_to_halves(pts[..., 0, :, :])
    yh = words_to_halves(pts[..., 1, :, :])
    inf = (mask != 0).expand(xh.shape[:-2])
    one = cv.F2.one(inf.shape, pts.device)
    acc = cv.pt_mul_bits(cv.F2, (xh, yh, one, inf), bits)
    lanes_first = tuple(c.movedim(-3, 0) for c in acc[:3]) + (
        acc[3].movedim(-1, 0),)
    x, y, rinf = cv.pt_to_affine(cv.F2, cv.pt_fold(cv.F2, lanes_first))
    xy = torch.stack([x, y], dim=-3)
    xy = torch.where(rinf[..., None, None, None], torch.zeros_like(xy), xy)
    return (halves_to_words(xy),
            rinf.reshape(rinf.shape + (1,)).to(torch.int32))


def _lib():
    from . import _build

    return _build.library("msm")


def msm(pts: torch.Tensor, mask: torch.Tensor, bits: torch.Tensor):
    """Σ bitsᵢ·Pᵢ over the unmasked lanes -> (xy (2, 2, 12), inf (1,))."""
    b = pts.shape[0]
    if b < 1 or bits.dim() != 2 or bits.shape[1] < 1:
        raise ValueError("msm: needs b >= 1 lanes and bits (b, nbits)")
    nbits = bits.shape[1]
    for name, t, shape in (("pts", pts, (b, 2, 2, NWORDS)),
                           ("mask", mask, (b,)), ("bits", bits, (b, nbits))):
        _check(name, t, shape, pts.device)
    if pts.device.type == "cpu":
        return msm_plain(pts, mask, bits)
    if pts.device.type != "cuda":
        raise ValueError(f"msm: unsupported device {pts.device}")
    lib = _lib()
    scratch = torch.empty(lib.msm_scratch_words(b), dtype=torch.int32,
                          device=pts.device)
    out = torch.empty(4 * NWORDS + 1, dtype=torch.int32, device=pts.device)
    consts = _consts_on(pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = lib.msm_launch(_ptr(consts), consts.numel(), _ptr(pts), _ptr(mask),
                         _ptr(bits), nbits, _ptr(scratch), scratch.numel(),
                         _ptr(out), b, ctypes.c_void_p(stream))
    _raise_on(err, "msm kernels")
    LAUNCHES["msm"] += 1
    return out[:4 * NWORDS].view(XY_SHAPE), out[4 * NWORDS:]
