"""Plain PyTorch Fp/Fp2/Fp6/Fp12 arithmetic — the plain version of
``csrc/fp.cuh``.

Counterpart of the JAX package's ``ops/bl.py``: the same tower
(``Fp2 = Fp[u]/(u²+1)``, ``Fp6 = Fp2[v]/(v³−ξ)``, ξ = 1+u,
``Fp12 = Fp6[w]/(w²−v)``), the same Montgomery radix R = 2^384 and the
same formulas — Karatsuba ``f2_mul``/``f6_mul``/``f12_mul``, the
complex-square ``f12_sqr``, Granger–Scott ``f12_cyclotomic_sqr``
(``bl.py:1056``), the γ-table ``f12_frobenius`` (``bl.py:984``), Fermat
``fp_inv`` — so that a value computed here equals, as an element of the
field, the one ``bl`` computes from the same inputs.

Representation: int64 tensors of 24 little-endian 16-bit half-words of
the canonical Montgomery value (``ops/limb.py``), trailing shapes
``(24,)``, ``(2, 24)``, ``(3, 2, 24)``, ``(2, 3, 2, 24)``; any leading
batch shape broadcasts. Every function returns canonical values (in
[0, p)); 16-bit digits keep every limb product (< 2^32) and every column
sum of a 24-limb product (< 2^37) exact in int64. The functions run on
any device; the tests run them on the CPU, and the chip smoke runs them
on the card to hold the CUDA kernels against.

Per call, the Fp products of a tower level are stacked into ONE
``mont_mul``, and its independent additions into one carry pass, so the
Python-level op count stays per level, not per Fp operation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..crypto import fields as hf
from ..crypto.fields import P
from .limb import HMASK, NHALF, ONE_MONT, R_MONT, int_to_halves

_I64 = torch.int64

# ---------------------------------------------------------------------------
# constants (per device, built on first use)
# ---------------------------------------------------------------------------

_NPRIME = (-pow(P, -1, R_MONT)) % R_MONT     # -p^-1 mod 2^384


def _frob_gammas(k: int) -> list[list[int]]:
    """γ_k row for the w-basis Frobenius: 6 Fp2 coefficients, Montgomery."""
    return [[g.c0 * R_MONT % P, g.c1 * R_MONT % P]
            for g in hf._FROBENIUS_GAMMA[k]]


PM2_BITS = [int(c) for c in bin(P - 2)[2:]]    # MSB-first, 381 bits

_CONST_INTS = {
    "P": [P],
    "NPRIME": [_NPRIME],
    "ONE": [ONE_MONT],
    "GAMMA1": [v for g in _frob_gammas(1) for v in g],
    "GAMMA2": [v for g in _frob_gammas(2) for v in g],
}
_CONSTS: dict[tuple[str, str], torch.Tensor] = {}

# Fp products computed by mont_mul since the last reset (all lanes): the
# kernels follow the same formulas, so this counts their products too.
N_FP_PRODUCTS = 0


def _c(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        rows = [int_to_halves(v) for v in _CONST_INTS[name]]
        t = torch.tensor(rows, dtype=_I64, device=device)
        if name.startswith("GAMMA"):
            t = t.reshape(6, 2, NHALF)
        else:
            t = t[0]
        _CONSTS[key] = t
    return t


# index of output column i + j for every (i, j) of a 24x24 product
_COL = {}


def _col_index(device) -> torch.Tensor:
    key = str(device)
    idx = _COL.get(key)
    if idx is None:
        r = torch.arange(NHALF, device=device)
        idx = (r[:, None] + r[None, :]).reshape(-1)
        _COL[key] = idx
    return idx


# ---------------------------------------------------------------------------
# Fp: carries, Montgomery product, add/sub
# ---------------------------------------------------------------------------

def _norm(t: torch.Tensor):
    """Exact carry propagation of (possibly signed) int64 limbs.

    Returns (limbs in [0, 2^16), top) with value(t) = value(limbs) +
    top·2^(16·n): the carry out of the last limb is returned, not kept."""
    top = torch.zeros(t.shape[:-1], dtype=_I64, device=t.device)
    while True:
        c = t >> 16                     # arithmetic: floor division
        if not bool(c.any()):
            return t, top
        top = top + c[..., -1]
        t = (t & HMASK) + F.pad(c[..., :-1], (1, 0))


def _conv(a: torch.Tensor, b: torch.Tensor, n_out: int) -> torch.Tensor:
    """Column sums of the schoolbook product of two 24-limb operands,
    truncated to n_out columns (no carries)."""
    prod = a[..., :, None] * b[..., None, :]
    shape = prod.shape[:-2]
    out = torch.zeros(shape + (2 * NHALF,), dtype=_I64, device=a.device)
    out.index_add_(-1, _col_index(a.device), prod.reshape(shape + (-1,)))
    return out[..., :n_out]


def _csub(r: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of a value in [0, 2p) reduced to [0, p)."""
    d, top = _norm(r - _c("P", r.device))
    return torch.where((top < 0)[..., None], r, d)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R^-1 mod p (separated-operand Montgomery product).

    The low half of the unnormalised product is congruent to the product
    mod R, so m = (t mod R)·(−p^-1) mod R is taken from it directly (its
    column sums stay < 2^59). u = t + m·p is divisible by R: after three
    carry-save rounds the low half's limbs are <= 2^16 and its value is
    a multiple of 2^384 below 2^385, so it is 0 or 2^384 and one more
    carry reaches the high half iff any low limb is non-zero. That skips
    the 24-limb ripple an exact carry pass over the low half would take.
    Result (t + m·p)/R < 2p, then one conditional subtraction."""
    global N_FP_PRODUCTS
    t = _conv(a, b, 2 * NHALF)
    N_FP_PRODUCTS += t.numel() // (2 * NHALF)
    m, _ = _norm(_conv(t[..., :NHALF], _c("NPRIME", a.device), NHALF))
    u = t + _conv(m, _c("P", a.device), 2 * NHALF)
    lo, carry = u[..., :NHALF], 0
    for _ in range(3):                  # column sums < 2^38
        c = lo >> 16
        carry = carry + c[..., -1]
        lo = (lo & HMASK) + F.pad(c[..., :-1], (1, 0))
    carry = carry + (lo != 0).any(dim=-1).to(_I64)
    hi, _ = _norm(u[..., NHALF:] + F.pad(carry[..., None], (0, NHALF - 1)))
    return _csub(hi)


def mont_sqr(a):
    return mont_mul(a, a)


def add(a, b):
    """a + b mod p: a + b and a + b − p are normalised in one stacked
    carry pass; the second is kept unless it is negative."""
    s = a + b
    r, top = _norm(torch.stack([s, s - _c("P", s.device)]))
    return torch.where((top[1] < 0)[..., None], r[0], r[1])


def sub(a, b):
    """a − b mod p: a − b and a − b + p normalised together; the first
    is kept unless it is negative."""
    d = a - b
    r, top = _norm(torch.stack([d, d + _c("P", d.device)]))
    return torch.where((top[0] < 0)[..., None], r[1], r[0])


def add_sub(a, b):
    """(a + b, a − b) mod p, all four candidates normalised together."""
    pc = _c("P", a.device)
    sm, df = a + b, a - b
    r, top = _norm(torch.stack(torch.broadcast_tensors(
        sm, sm - pc, df, df + pc)))
    return (torch.where((top[1] < 0)[..., None], r[0], r[1]),
            torch.where((top[2] < 0)[..., None], r[3], r[2]))


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul_small(a, k: int):
    """k·a for a small positive int k (double-and-add over k's bits)."""
    acc = None
    for bit in bin(k)[2:]:
        acc = None if acc is None else add(acc, acc)
        if bit == "1":
            acc = a if acc is None else add(acc, a)
    return acc


def fp_one(shape, device) -> torch.Tensor:
    return _c("ONE", device).expand(tuple(shape) + (NHALF,)).clone()


def fp_inv(a):
    """a^(p-2): MSB-first square-and-multiply over the bits of p-2."""
    acc = fp_one(a.shape[:-1], a.device)
    for bit in PM2_BITS:
        acc = mont_sqr(acc)
        if bit:
            acc = mont_mul(acc, a)
    return acc


# ---------------------------------------------------------------------------
# Fp2: (..., 2, 24)
# ---------------------------------------------------------------------------

def f2(c0, c1):
    return torch.stack([c0, c1], dim=-2)


def f2_mul(a, b):
    """Karatsuba: 3 Fp products in one stacked mont_mul."""
    a0, a1, b0, b1 = torch.broadcast_tensors(
        a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :])
    sa, sb = add(torch.stack([a0, b0]), torch.stack([a1, b1])).unbind(0)
    v = mont_mul(torch.stack([a0, a1, sa], dim=-2),
                 torch.stack([b0, b1, sb], dim=-2))
    s01, d01 = add_sub(v[..., 0, :], v[..., 1, :])
    return f2(d01, sub(v[..., 2, :], s01))


def f2_sqr(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    s, d = add_sub(a0, a1)
    v = mont_mul(torch.stack([s, a0], dim=-2), torch.stack([d, a1], dim=-2))
    return f2(v[..., 0, :], add(v[..., 1, :], v[..., 1, :]))


def f2_mul_fp(a, s):
    """Fp2 · Fp (s: (..., 24))."""
    return mont_mul(a, s[..., None, :])


def f2_conj(a):
    return f2(a[..., 0, :], neg(a[..., 1, :]))


def f2_mul_by_xi(a):
    s, d = add_sub(a[..., 0, :], a[..., 1, :])
    return f2(d, s)


def f2_inv(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    sq = mont_mul(a, a)
    t = fp_inv(add(sq[..., 0, :], sq[..., 1, :]))
    return f2(mont_mul(a0, t), neg(mont_mul(a1, t)))


# ---------------------------------------------------------------------------
# Fp6: (..., 3, 2, 24)
# ---------------------------------------------------------------------------

def f6(c0, c1, c2):
    return torch.stack([c0, c1, c2], dim=-3)


def f6_mul(a, b):
    """Karatsuba over Fp2: 6 Fp2 products in one stacked f2_mul; the
    additions of each step are stacked into one call too."""
    a0, a1, a2, b0, b1, b2 = torch.broadcast_tensors(
        a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :],
        b[..., 0, :, :], b[..., 1, :, :], b[..., 2, :, :])
    s = add(torch.stack([a1, a0, a0, b1, b0, b0]),
            torch.stack([a2, a1, a2, b2, b1, b2]))
    v = f2_mul(torch.stack([a0, a1, a2, s[0], s[1], s[2]], dim=-3),
               torch.stack([b0, b1, b2, s[3], s[4], s[5]], dim=-3))
    v0, v1, v2 = v[..., 0, :, :], v[..., 1, :, :], v[..., 2, :, :]
    m = v[..., 3:, :, :].movedim(-3, 0)          # m12, m01, m02
    d = sub(m, add(torch.stack([v1, v0, v0]), torch.stack([v2, v1, v2])))
    x = f2_mul_by_xi(torch.stack([d[0], v2]))
    c = add(torch.stack([v0, d[1], d[2]]), torch.stack([x[0], x[1], v1]))
    return f6(c[0], c[1], c[2])


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_by_v(a):
    return f6(f2_mul_by_xi(a[..., 2, :, :]), a[..., 0, :, :],
              a[..., 1, :, :])


def f6_inv(a):
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    t0 = sub(f2_sqr(a0), f2_mul_by_xi(f2_mul(a1, a2)))
    t1 = sub(f2_mul_by_xi(f2_sqr(a2)), f2_mul(a0, a1))
    t2 = sub(f2_sqr(a1), f2_mul(a0, a2))
    denom = add(f2_mul(a0, t0),
                add(f2_mul_by_xi(f2_mul(a2, t1)),
                    f2_mul_by_xi(f2_mul(a1, t2))))
    dinv = f2_inv(denom)
    return f6(f2_mul(t0, dinv), f2_mul(t1, dinv), f2_mul(t2, dinv))


# ---------------------------------------------------------------------------
# Fp12: (..., 2, 3, 2, 24)
# ---------------------------------------------------------------------------

def f12(c0, c1):
    return torch.stack([c0, c1], dim=-4)


def f12_one(shape, device) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (2, 3, 2, NHALF), dtype=_I64,
                      device=device)
    out[..., 0, 0, 0, :] = _c("ONE", device)
    return out


def f12_mul(a, b):
    """Karatsuba over Fp6: 3 Fp6 products in one stacked f6_mul."""
    a0, a1, b0, b1 = torch.broadcast_tensors(
        a[..., 0, :, :, :], a[..., 1, :, :, :],
        b[..., 0, :, :, :], b[..., 1, :, :, :])
    sa, sb = add(torch.stack([a0, b0]), torch.stack([a1, b1])).unbind(0)
    v = f6_mul(torch.stack([a0, a1, sa], dim=-4),
               torch.stack([b0, b1, sb], dim=-4))
    v0, v1, v2 = v[..., 0, :, :, :], v[..., 1, :, :, :], v[..., 2, :, :, :]
    c0, s01 = add(torch.stack([v0, v0]),
                  torch.stack([f6_mul_by_v(v1), v1])).unbind(0)
    return f12(c0, sub(v2, s01))


def f12_sqr(a):
    """Complex squaring: c0 = (a0+a1)(a0+v·a1) − v0 − v·v0, c1 = 2·v0."""
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    s = add(torch.stack([a0, a0]), torch.stack([a1, f6_mul_by_v(a1)]))
    v = f6_mul(torch.stack([a0, s[0]], dim=-4),
               torch.stack([a1, s[1]], dim=-4))
    v0, w = v[..., 0, :, :, :], v[..., 1, :, :, :]
    t = add(torch.stack([v0, v0]), torch.stack([f6_mul_by_v(v0), v0]))
    return f12(sub(w, t[0]), t[1])


def f12_conj(a):
    return f12(a[..., 0, :, :, :], neg(a[..., 1, :, :, :]))


def f12_to_w(a):
    """(..., 2, 3, 2, 24) -> (..., 6, 2, 24) in w-power order."""
    c0, c1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    return torch.stack([c0[..., 0, :, :], c1[..., 0, :, :],
                        c0[..., 1, :, :], c1[..., 1, :, :],
                        c0[..., 2, :, :], c1[..., 2, :, :]], dim=-3)


def f12_from_w(w):
    return f12(w[..., 0::2, :, :], w[..., 1::2, :, :])


def f12_frobenius(a, power: int):
    """a^(p^power) for power in {1, 2}: conjugate the w-coefficients on
    odd powers, then scale coefficient k by γ_power[k]."""
    w = f12_to_w(a)
    if power % 2 == 1:
        w = f2_conj(w)
    return f12_from_w(f2_mul(w, _c(f"GAMMA{power}", a.device)))


def f12_cyclotomic_sqr(a):
    """Granger–Scott squaring (valid for cyclotomic a): three Fp4
    squarings, then the 3t ∓ 2g finish (``bl._cyc_finish``)."""
    w = f12_to_w(a)
    g = [w[..., i, :, :] for i in range(6)]
    x = torch.stack([g[0], g[1], g[2]], dim=-3)
    y = torch.stack([g[3], g[4], g[5]], dim=-3)
    t0, t1, s = f2_sqr(torch.stack([x, y, add(x, y)], dim=-4)).unbind(-4)
    lo, t01 = add(torch.stack([t0, t0]),
                  torch.stack([f2_mul_by_xi(t1), t1])).unbind(0)
    a0, b0, c0 = lo.unbind(-3)                # lo = t0 + ξ·t1
    a1, b1, c1 = sub(s, t01).unbind(-3)       # hi = s − t0 − t1
    # h_k = 3·t_k − 2·g_k for even k (fmi), 3·t_k + 2·g_k for odd k (gpl)
    t_f = torch.stack([a0, b0, c0])           # k = 0, 2, 4
    t_g = torch.stack([f2_mul_by_xi(c1), a1, b1])   # k = 1, 3, 5
    u = torch.cat([sub(t_f, torch.stack([g[0], g[2], g[4]])),
                   add(t_g, torch.stack([g[1], g[3], g[5]]))])
    h = add(add(u, u), torch.cat([t_f, t_g]))
    return f12_from_w(torch.stack([h[0], h[3], h[1], h[4], h[2], h[5]],
                                  dim=-3))


def f12_inv(a):
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    denom = sub(f6_sqr(a0), f6_mul_by_v(f6_sqr(a1)))
    dinv = f6_inv(denom)
    return f12(f6_mul(a0, dinv), neg(f6_mul(a1, dinv)))


def f12_is_one(a) -> torch.Tensor:
    """(...,) bool: a == 1 (canonical values compare limb for limb)."""
    one = f12_one((), a.device)
    return (a == one).flatten(-4).all(dim=-1)
