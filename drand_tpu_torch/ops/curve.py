"""Plain PyTorch Jacobian point arithmetic on G1 and G2 — the plain
version of ``csrc/curve.cuh``.

Counterpart of the JAX package's ``ops/curve.py`` (``pt_dbl``,
``pt_add``, ``pt_to_affine``, ``scalar_to_bits``) and of
``ops/bl_curve.pt_mul_bits_getter``: one set of a = 0 Jacobian formulas,
generic over a field namespace (``F1`` for Fp, ``F2`` for Fp2) on top of
``ops/field.py``. A point is a tuple ``(X, Y, Z, inf)``: int64 half-word
tensors of trailing shape ``(24,)`` (Fp) or ``(2, 24)`` (Fp2) and a bool
mask. The formulas, the order of their cases and the coordinates of the
point at infinity (1, 1, 0) are the JAX ones, so a Jacobian result is
the same field element triple the JAX graph computes, and the CUDA
kernels, which follow the same formulas, agree with it word for word.

Independent field products of one formula are stacked into one field
call, so the Python op count stays per formula step, not per product.

The G2 maps of ``ops/bl_curve.py`` follow (``pt_neg``, ``psi``,
``psi2``, ``mul_x``, ``subgroup_check``, ``clear_cofactor``): the plain
version of the point code of ``csrc/h2c.cu``. Their constants come from
``crypto/endo.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..crypto import endo
from ..crypto.fields import X_BLS
from . import field as fd
from .limb import NHALF, int_to_halves, to_mont


def _f2_one(shape, device):
    out = torch.zeros(tuple(shape) + (2, NHALF), dtype=torch.int64,
                      device=device)
    out[..., 0, :] = fd.fp_one((), device)
    return out


# Additions and subtractions are those of ops/field.py for both fields;
# a namespace holds what differs: products, inverse, constants, rank.
F1 = SimpleNamespace(
    elem_ndim=1, mul=fd.mont_mul, sqr=fd.mont_sqr, inv=fd.fp_inv,
    one=fd.fp_one,
    zero=lambda shape, device: torch.zeros(tuple(shape) + (NHALF,),
                                           dtype=torch.int64, device=device))

F2 = SimpleNamespace(
    elem_ndim=2, mul=fd.f2_mul, sqr=fd.f2_sqr, inv=fd.f2_inv, one=_f2_one,
    zero=lambda shape, device: torch.zeros(tuple(shape) + (2, NHALF),
                                           dtype=torch.int64, device=device))


def _dbl(x):
    return fd.add(x, x)


def is_zero(F, a) -> torch.Tensor:
    """(...,) bool: a == 0 (canonical values)."""
    return (a == 0).flatten(-F.elem_ndim).all(dim=-1)


def select(F, cond, a, b):
    """Per-lane a where cond else b (cond broadcast over the element)."""
    return torch.where(cond.reshape(cond.shape + (1,) * F.elem_ndim), a, b)


def pt_select(F, cond, p, q):
    return (select(F, cond, p[0], q[0]), select(F, cond, p[1], q[1]),
            select(F, cond, p[2], q[2]), torch.where(cond, p[3], q[3]))


def pt_infinity(F, shape, device):
    """The point at infinity as the JAX formulas carry it: (1, 1, 0)."""
    one = F.one(shape, device)
    return (one, one.clone(), F.zero(shape, device),
            torch.ones(tuple(shape), dtype=torch.bool, device=device))


def pt_dbl(F, p):
    """2P (a = 0 Jacobian doubling, ``curve.pt_dbl``); the inf flag
    passes through and the formula runs on every lane."""
    X, Y, Z, inf = p
    A, B = F.sqr(torch.stack([X, Y])).unbind(0)
    XB2, C = F.sqr(torch.stack([fd.add(X, B), B])).unbind(0)
    D = _dbl(fd.sub(XB2, fd.add(A, C)))
    E = fd.add(_dbl(A), A)
    X3 = fd.sub(F.sqr(E), _dbl(D))
    EDX, YZ = F.mul(torch.stack([E, Y]),
                    torch.stack([fd.sub(D, X3), Z])).unbind(0)
    Y3 = fd.sub(EDX, _dbl(_dbl(_dbl(C))))
    return X3, Y3, _dbl(YZ), inf


def pt_add(F, p1, p2):
    """Complete P1 + P2 (``curve.pt_add``): H = 0 and S = 0 doubles P1,
    H = 0 and S ≠ 0 gives infinity, an operand at infinity gives the
    other operand. The doubling is computed only when some lane needs
    it; the result is the same as computing it everywhere."""
    X1, Y1, Z1, inf1 = p1
    X2, Y2, Z2, inf2 = p2
    Z1Z1, Z2Z2 = F.sqr(torch.stack(torch.broadcast_tensors(Z1, Z2))).unbind(0)
    U1, U2, T1, T2 = F.mul(
        torch.stack(torch.broadcast_tensors(X1, X2, Y1, Y2)),
        torch.stack(torch.broadcast_tensors(Z2Z2, Z1Z1, Z2, Z1))).unbind(0)
    S1, S2 = F.mul(torch.stack([T1, T2]),
                   torch.stack([Z2Z2, Z1Z1])).unbind(0)
    H = fd.sub(U2, U1)
    Sd = fd.sub(S2, S1)
    r = _dbl(Sd)
    HH, RR, ZZ = F.sqr(torch.stack(
        torch.broadcast_tensors(H, r, fd.add(Z1, Z2)))).unbind(0)
    I = _dbl(_dbl(HH))
    J, V = F.mul(torch.stack([H, U1]), torch.stack([I, I])).unbind(0)
    X3 = fd.sub(RR, fd.add(J, _dbl(V)))
    RV, SJ, Z3 = F.mul(
        torch.stack([r, S1, fd.sub(ZZ, fd.add(Z1Z1, Z2Z2))]),
        torch.stack([fd.sub(V, X3), J, H])).unbind(0)
    Y3 = fd.sub(RV, _dbl(SJ))
    shape = torch.broadcast_shapes(inf1.shape, inf2.shape)
    out = (X3, Y3, Z3, torch.zeros(shape, dtype=torch.bool,
                                   device=X3.device))

    h_zero = is_zero(F, H)
    s_zero = is_zero(F, Sd)
    both_live = ~inf1 & ~inf2
    dbl_case = h_zero & s_zero & both_live
    inf_case = h_zero & ~s_zero & both_live
    if bool(dbl_case.any()):
        out = pt_select(F, dbl_case, pt_dbl(F, _expand(p1, shape)), out)
    out = pt_select(F, inf_case, pt_infinity(F, shape, X3.device), out)
    out = pt_select(F, inf2 & ~inf1, _expand(p1, shape), out)
    return pt_select(F, inf1, _expand(p2, shape), out)


def _expand(p, shape):
    n = len(shape)
    return tuple(c.expand(tuple(shape) + c.shape[n:]) if i < 3
                 else c.expand(shape) for i, c in enumerate(p))


def pt_to_affine(F, p):
    """(x, y, inf): X/Z², Y/Z³, with arbitrary values where inf is set
    (``curve.pt_to_affine``)."""
    X, Y, Z, inf = p
    zi = F.inv(select(F, inf, F.one(inf.shape, Z.device), Z))
    zi2 = F.sqr(zi)
    x, zi3 = F.mul(torch.stack([X, zi2]), torch.stack([zi2, zi])).unbind(0)
    return x, F.mul(Y, zi3), inf


def pt_mul_bits(F, p, bits: torch.Tensor):
    """Per-lane MSB-first double-and-add from infinity
    (``bl_curve.pt_mul_bits_getter`` with a per-lane bit row): bits
    (..., nbits) 0/1 ints. Every step doubles; lanes whose bit is set
    take the complete addition of p.

    The result is that of running every step on every lane, with two
    shortcuts that change no word of it: steps before the first set bit
    of any lane are skipped (the doubling of (1, 1, 0) is (1, 1, 0)), and
    the addition is not computed at a step where no lane's bit is set."""
    acc = pt_infinity(F, p[3].shape, p[0].device)
    cols = (bits != 0).reshape(-1, bits.shape[-1]).any(dim=0).tolist()
    start = cols.index(True) if True in cols else len(cols)
    for i in range(start, len(cols)):
        acc = pt_dbl(F, acc)
        if cols[i]:
            acc = pt_select(F, bits[..., i] != 0, pt_add(F, acc, p), acc)
    return acc


def pt_fold(F, p):
    """Sum over the leading lane axis (a log tree of complete additions;
    the order does not change the group element)."""
    while p[3].shape[0] > 1:
        n = p[3].shape[0]
        if n % 2:
            p = tuple(torch.cat([c, i]) for c, i in
                      zip(p, pt_infinity(F, (1,) + p[3].shape[1:],
                                         p[0].device)))
            n += 1
        h = n // 2
        p = pt_add(F, tuple(c[:h] for c in p), tuple(c[h:] for c in p))
    return tuple(c[0] for c in p)


def scalar_to_bits(k: int, nbits: int) -> np.ndarray:
    """Host: MSB-first fixed-width bit vector of a non-negative scalar."""
    if k < 0 or k >> nbits:
        raise ValueError("scalar out of range")
    return np.array([(k >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                    dtype=np.int32)


# ---------------------------------------------------------------------------
# G2 maps (ops/bl_curve.py): ψ, [x], Scott's check, Budroni-Pintore
# ---------------------------------------------------------------------------

# |x| MSB first; x = X_BLS < 0
X_ABS_BITS = [int(c) for c in bin(-X_BLS)[2:]]
_F2_CONSTS: dict[tuple[int, int, str], torch.Tensor] = {}


def f2_const(value, device) -> torch.Tensor:
    """A host Fp2 constant as (2, 24) Montgomery half-words on device."""
    key = (value.c0, value.c1, str(device))
    t = _F2_CONSTS.get(key)
    if t is None:
        t = torch.tensor([int_to_halves(to_mont(value.c0)),
                          int_to_halves(to_mont(value.c1))],
                         dtype=torch.int64, device=device)
        _F2_CONSTS[key] = t
    return t


def _pair_const(cx, cy, like):
    """(2, 1, ..., 2, 24): two Fp2 constants against a stack of two
    coordinates shaped like ``like``."""
    c = torch.stack([f2_const(cx, like.device), f2_const(cy, like.device)])
    return c.reshape((2,) + (1,) * (like.dim() - 2) + c.shape[1:])


def pt_neg(p):
    return p[0], fd.neg(p[1]), p[2], p[3]


def psi(p):
    """ψ on a Jacobian G2 point: (c_x·X̄, c_y·Ȳ, Z̄) — no inversion
    (``bl_curve.psi``)."""
    X, Y, Z, inf = p
    c = _pair_const(endo.PSI_CX, endo.PSI_CY, X)
    XY = F2.mul(fd.f2_conj(torch.stack([X, Y])), c)
    return XY[0], XY[1], fd.f2_conj(Z), inf


def psi2(p):
    """ψ² on a Jacobian G2 point: (c2_x·X, c2_y·Y, Z)."""
    X, Y, Z, inf = p
    XY = F2.mul(torch.stack([X, Y]), _pair_const(endo.PSI2_CX, endo.PSI2_CY, X))
    return XY[0], XY[1], Z, inf


def mul_x(F, p):
    """[x]P with x = X_BLS < 0 (``bl_curve.mul_x``): [|x|]P MSB first
    from P itself (the leading bit), 63 doublings and an addition on each
    of the 5 further set bits — the same for every lane — then negated."""
    acc = p
    for bit in X_ABS_BITS[1:]:
        acc = pt_dbl(F, acc)
        if bit:
            acc = pt_add(F, acc, p)
    return pt_neg(acc)


def subgroup_check(F, q) -> torch.Tensor:
    """(...,) bool: ψ(Q) == [x]Q by Jacobian cross-multiplication (Scott;
    ``bl_curve.subgroup_check``). Infinity is a member."""
    lhs, rhs = psi(q), mul_x(F, q)
    z1s, z2s = F.sqr(torch.stack([lhs[2], rhs[2]])).unbind(0)
    z1c, z2c = F.mul(torch.stack([z1s, z2s]),
                     torch.stack([lhs[2], rhs[2]])).unbind(0)
    a = F.mul(torch.stack([lhs[0], rhs[0], lhs[1], rhs[1]]),
              torch.stack([z2s, z1s, z2c, z1c]))
    ex = is_zero(F, fd.sub(a[0], a[1]))
    ey = is_zero(F, fd.sub(a[2], a[3]))
    both = ex & ey & ~lhs[3] & ~rhs[3]
    return both | (lhs[3] & rhs[3]) | q[3]


def clear_cofactor(F, p):
    """[h_eff]P by Budroni-Pintore (``bl_curve.clear_cofactor``):
    [x²−x−1]P + ψ([x−1]P) + ψ²([2]P) with t1 = [x]P, t2 = [x]t1."""
    t1 = mul_x(F, p)
    t2 = mul_x(F, t1)
    part1 = pt_add(F, pt_add(F, t2, pt_neg(t1)), pt_neg(p))
    part2 = psi(pt_add(F, t1, pt_neg(p)))
    part3 = psi2(pt_dbl(F, p))
    return pt_add(F, pt_add(F, part1, part2), part3)
