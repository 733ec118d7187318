"""G1 Horner evaluation of commitment polynomials on the card: the kernel
of ``csrc/eval.cu``, its wrapper with its launch counter, and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/pallas_eval.py`` (``_eval_kernel``,
``horner_bl``): per lane ``acc = C_{t-1}; repeat acc = [m]·acc + C_k``
with m = idx + 1. Unlike the reference kernel, the bits are per lane and
the ladder's width is the width of the bits given (the engine sends
11). ``horner`` given CPU tensors runs ``horner_plain``; given CUDA
tensors it launches the kernel or raises.

Layouts (int32 words of canonical Montgomery values, ``ops/limb.py``):

    commits  (t, b, 2, 12)   affine x / y of commitment k of lane j
    bits     (b, nbits)      int32 0/1, MSB first: the bits of idx + 1
    xyz      (b, 3, 12)      Jacobian X, Y, Z of each lane's result
    inf      (b,)            int32, 1 iff the result is infinity

With ``affine=True`` every finite result is normalised to Z = 1 (X, Y
are then its affine coordinates).
"""

from __future__ import annotations

import torch

from . import curve as cv
from .limb import NWORDS, halves_to_words, words_to_halves
from .pairing import _check, _consts_on, _launch_on, _ptr, _raise_on

# Launches of the Horner kernel on the card (plain int).
LAUNCHES = {"horner": 0}


def horner_plain(commits: torch.Tensor, bits: torch.Tensor,
                 affine: bool = False):
    """Plain version, on any device. Returns (xyz, inf)."""
    c = words_to_halves(commits)                    # (t, b, 2, 24)
    t, b = c.shape[0], c.shape[1]
    one = cv.F1.one((b,), c.device)
    live = torch.zeros(b, dtype=torch.bool, device=c.device)
    acc = (c[t - 1, :, 0], c[t - 1, :, 1], one, live)
    for k in range(t - 2, -1, -1):
        acc = cv.pt_mul_bits(cv.F1, acc, bits)
        acc = cv.pt_add(cv.F1, acc, (c[k, :, 0], c[k, :, 1], one, live))
    X, Y, Z, inf = acc
    if affine:
        x, y, _ = cv.pt_to_affine(cv.F1, acc)
        fin = ~inf
        X = cv.select(cv.F1, fin, x, X)
        Y = cv.select(cv.F1, fin, y, Y)
        Z = cv.select(cv.F1, fin, one, Z)
    return (halves_to_words(torch.stack([X, Y, Z], dim=1)),
            inf.to(torch.int32))


def _lib():
    from . import _build

    return _build.library("eval")


def horner(commits: torch.Tensor, bits: torch.Tensor, affine: bool = False):
    """Horner of t commitments per lane at that lane's abscissa ->
    (xyz (b, 3, 12), inf (b,))."""
    if commits.dim() != 4 or bits.dim() != 2:
        raise ValueError("horner: commits (t, b, 2, 12), bits (b, nbits)")
    t, b = commits.shape[0], commits.shape[1]
    nbits = bits.shape[1]
    if t < 1 or b < 1 or nbits < 1:
        raise ValueError("horner: needs t, b, nbits >= 1")
    _check("commits", commits, (t, b, 2, NWORDS), commits.device)
    _check("bits", bits, (b, nbits), commits.device)
    if commits.device.type == "cpu":
        return horner_plain(commits, bits, affine)
    if commits.device.type != "cuda":
        raise ValueError(f"horner: unsupported device {commits.device}")
    xyz = torch.empty((b, 3, NWORDS), dtype=torch.int32,
                      device=commits.device)
    inf = torch.empty((b,), dtype=torch.int32, device=commits.device)
    consts = _consts_on(commits.device)
    lib = _lib()
    with _launch_on(commits) as stream:
        err = lib.eval_horner_launch(_ptr(consts), consts.numel(),
                                     _ptr(commits), t, _ptr(bits), nbits,
                                     int(affine), _ptr(xyz), _ptr(inf), b,
                                     stream)
    _raise_on(err, "eval_horner_kernel")
    LAUNCHES["horner"] += 1
    return xyz, inf
