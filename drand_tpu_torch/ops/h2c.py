"""Hash-to-G2 and signature decompression from wire bytes: the host byte
prep, and the plain PyTorch versions of the two kernels of
``csrc/h2c.cu``.

Counterpart of the JAX package's ``ops/h2c.py`` (host prep,
``msgs_to_u`` :195 and ``sigs_to_x`` :210) and ``ops/bl_h2c.py``
(``sqrt_f2``, ``sgn0_f2``, ``lex_largest_f2``, ``map_to_curve``,
``decompress_g2_bl``), as ``ops/pallas_wire.py`` chains them:

- host: SHA-256 expansion of each message to its two Fp2 u-values
  (RFC 9380 ``hash_to_field``), and the split of each 96-byte
  compressed signature into its x-coordinate, sign flag and header
  checks — nothing else of hashing or decoding runs on the host;
- ``hash_to_g2_plain``: SSWU onto E' with its tv = 0 exceptional case,
  the 3-isogeny onto E2 (as a Jacobian point, no inversion), the sum of
  the two maps, Budroni-Pintore cofactor clearing
  (``ops/curve.clear_cofactor``), then to affine;
- ``decompress_plain``: y = √(x³ + 4(1+u)) by the (p²+7)/16 candidate
  (4-bit windows) and the four 4th-root-of-unity corrections, the zcash
  sign rule, Scott's subgroup check ψ(Q) == [x]Q.

The 12-bit-limb machinery of ``bl_h2c`` (``canonicalize``,
``_lex_ge_rows``, ``exact_normalize``) is a TPU artefact and is not
carried over: the port keeps every value canonical, so sgn0 is the
parity of one from-Montgomery product, and "lexicographically largest"
compares c1, then c0, with (p−1)/2. Every output is affine and
therefore unique, and rejected lanes write zeros (with ``inf`` = 1 or
``ok`` = 0), so the kernels agree with these functions word for word on
every lane. Constants come from the port's host crypto
(``crypto/hash_to_curve.py``, ``crypto/fields.py``, ``crypto/endo.py``);
none is typed in.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import endo
from ..crypto.curves import PointG2
from ..crypto.fields import _FP2_ROOTS_OF_UNITY_4, P, Fp2
from ..crypto.hash_to_curve import (
    _A_PRIME, _B_OVER_ZA, _B_PRIME, _ISO_PARAMS, _MINUS_B_OVER_A, _Z_SSWU,
    DEFAULT_DST_G2, hash_to_field_fp2,
)
from . import curve as cv
from . import field as fd
from .limb import (NWORDS, fp_words, halves_to_words, int_to_halves,
                   int_to_words, words_to_halves)

_ISO_X0, _ISO_VSUM, _ISO_USUM, _ISO_C2, _ISO_C3 = _ISO_PARAMS
_B_G2 = Fp2(4, 4)
HALF_P = (P - 1) // 2
# sqrt in Fp2 (p² ≡ 9 mod 16): candidate a^((p²+7)/16), MSB first
SQRT_EXP = (P * P + 7) // 16
SQRT_BITS = [int(c) for c in bin(SQRT_EXP)[2:]]
SQRT_BITS_WIDTH = 768


# ---------------------------------------------------------------------------
# Host byte prep (ops/h2c.py:195-232 of the JAX package)
# ---------------------------------------------------------------------------

def _f2_words(x: Fp2) -> np.ndarray:
    return np.stack([fp_words(x.c0), fp_words(x.c1)])


def msgs_to_u(msgs: list[bytes], dst: bytes = DEFAULT_DST_G2) -> np.ndarray:
    """SHA-256 expansion of each message to its two Fp2 u-values, as
    (n, 2, 2, 12) int32 Montgomery words — the only host step of
    hashing."""
    out = np.zeros((len(msgs), 2, 2, NWORDS), np.int32)
    for i, msg in enumerate(msgs):
        u0, u1 = hash_to_field_fp2(msg, dst, 2)
        out[i, 0] = _f2_words(u0)
        out[i, 1] = _f2_words(u1)
    return out


def sigs_to_x(sigs: list[bytes]):
    """Split 96-byte compressed G2 signatures (zcash layout: the top bits
    of byte 0 are [compressed, infinity, sign], then c1 and c0 big-endian)
    into xs (n, 2, 12) Montgomery words [c0, c1], the sign flag (n,) and
    the header/range mask valid (n,): length 96, compressed bit set,
    infinity bit clear, c0 < p and c1 < p. Invalid rows hold zeros."""
    n = len(sigs)
    xs = np.zeros((n, 2, NWORDS), np.int32)
    sign = np.zeros(n, bool)
    valid = np.zeros(n, bool)
    for i, s in enumerate(sigs):
        if len(s) != 96:
            continue
        b0 = s[0]
        if not (b0 & 0x80) or (b0 & 0x40):
            continue
        c1 = int.from_bytes(bytes([b0 & 0x1F]) + s[1:48], "big")
        c0 = int.from_bytes(s[48:96], "big")
        if c0 >= P or c1 >= P:
            continue
        xs[i, 0] = fp_words(c0)
        xs[i, 1] = fp_words(c1)
        sign[i] = bool(b0 & 0x20)
        valid[i] = True
    return xs, sign, valid


_PAD_SIG_BYTES: bytes | None = None


def pad_sig() -> bytes:
    """A well-formed compressed G2 point (the generator) for the pad rows
    of a bucket (``engine._PAD_SIG`` of the JAX package)."""
    global _PAD_SIG_BYTES
    if _PAD_SIG_BYTES is None:
        _PAD_SIG_BYTES = PointG2.generator().to_bytes()
    return _PAD_SIG_BYTES


# ---------------------------------------------------------------------------
# The kernels' constant buffer
# ---------------------------------------------------------------------------

# Fp2 constants of struct H2cConsts (csrc/h2c.cu), in its order
_H2C_F2 = (_A_PRIME, _B_PRIME, _Z_SSWU, _MINUS_B_OVER_A, _B_OVER_ZA,
           _ISO_X0, _ISO_VSUM, _ISO_USUM, _ISO_C2, _ISO_C3, _B_G2,
           *_FP2_ROOTS_OF_UNITY_4,
           endo.PSI_CX, endo.PSI_CY, endo.PSI2_CX, endo.PSI2_CY)


def h2c_consts() -> np.ndarray:
    """The constant buffer of ``csrc/h2c.cu`` (struct H2cConsts, same
    order) as int32 words: the sqrt exponent's bit count, (p−1)/2 as a
    plain integer, the SSWU, isogeny, curve, 4th-root-of-unity and ψ/ψ²
    constants in Montgomery form, and the bits of (p²+7)/16. The shared
    field constants (p, R, the bits of |x| and p−2) are the pairing
    kernels' buffer, ``pairing.kernel_consts``."""
    head = np.array([len(SQRT_BITS), 0, 0, 0], np.int32)
    bits = np.zeros(SQRT_BITS_WIDTH, np.int32)
    bits[:len(SQRT_BITS)] = SQRT_BITS
    return np.concatenate([head, int_to_words(HALF_P),
                           *[_f2_words(c).reshape(-1) for c in _H2C_F2],
                           bits])


# ---------------------------------------------------------------------------
# Plain field helpers (half-word tensors, ops/field.py)
# ---------------------------------------------------------------------------

_RAW = {}


def _raw(value: int, device) -> torch.Tensor:
    """A plain (not Montgomery) integer as (24,) half-words."""
    key = (value, str(device))
    t = _RAW.get(key)
    if t is None:
        t = torch.tensor(int_to_halves(value), dtype=torch.int64,
                         device=device)
        _RAW[key] = t
    return t


_const = cv.f2_const


def _f2_eq(a, b) -> torch.Tensor:
    return (a == b).flatten(-2).all(dim=-1)


def _f2_pow(a, bits: list[int]):
    """a^e for e with MSB-first bits, by 4-bit fixed windows (the order of
    ``f2_pow_sqrt`` in csrc/h2c.cu): the table a^1..a^15 in four stacked
    levels (a^k = a^(k−q)·a^q, q the largest power of two below k), then
    per window four squarings and, for a nonzero digit, one product — the
    same on every lane."""
    tab = [None, a]
    q = 1
    while len(tab) < 16:
        ks = range(q + 1, min(2 * q, 15) + 1)
        v = fd.f2_mul(torch.stack([tab[k - q] for k in ks]),
                      torch.stack([tab[q]] * len(ks)))
        tab += list(v.unbind(0))
        q *= 2
    lead = len(bits) % 4 or 4
    acc = tab[int("".join(map(str, bits[:lead])), 2)]
    for i in range(lead, len(bits), 4):
        for _ in range(4):
            acc = fd.f2_sqr(acc)
        d = int("".join(map(str, bits[i:i + 4])), 2)
        if d:
            acc = fd.f2_mul(acc, tab[d])
    return acc


def sqrt_f2(a):
    """(root, is_square) of Fp2 values ``a`` (..., 2, 24): the candidate
    a^((p²+7)/16) times the first of the four 4th roots of unity whose
    square is ``a`` (cand·1 where none is: ``a`` is not a square)."""
    cand = _f2_pow(a, SQRT_BITS)
    roots = torch.stack([_const(r, a.device) for r in _FP2_ROOTS_OF_UNITY_4])
    r = fd.f2_mul(cand[..., None, :, :], roots)            # (..., 4, 2, 24)
    ok = _f2_eq(fd.f2_sqr(r), a[..., None, :, :])            # (..., 4)
    found = ok.any(dim=-1)
    first = torch.where(found, ok.to(torch.int64).argmax(dim=-1), 0)
    idx = first[..., None, None, None].expand(r.shape[:-3] + (1,) + r.shape[-2:])
    return r.gather(-3, idx).squeeze(-3), found


def _from_mont(a):
    """Montgomery -> canonical integer half-words (a·R^-1 mod p)."""
    return fd.mont_mul(a, _raw(1, a.device))


def sgn0_f2(a) -> torch.Tensor:
    """RFC 9380 sgn0 of Fp2 values: sgn0(c0) | (c0 == 0 & sgn0(c1))."""
    c = _from_mont(a)
    sign0 = (c[..., 0, 0] & 1) != 0
    zero0 = (c[..., 0, :] == 0).all(dim=-1)
    sign1 = (c[..., 1, 0] & 1) != 0
    return sign0 | (zero0 & sign1)


def lex_largest_f2(y) -> torch.Tensor:
    """The zcash sign rule: y is lexicographically larger than −y — c1 >
    (p−1)/2, or c1 == 0 and c0 > (p−1)/2 (``PointG2.
    _y_is_lexicographically_largest``)."""
    c = _from_mont(y)
    _, top = fd._norm(c - _raw(HALF_P + 1, y.device))
    gt = top >= 0                                           # (..., 2)
    c1_zero = (c[..., 1, :] == 0).all(dim=-1)
    return torch.where(c1_zero, gt[..., 0], gt[..., 1])


# ---------------------------------------------------------------------------
# SSWU + 3-isogeny (bl_h2c.map_to_curve)
# ---------------------------------------------------------------------------

def _g_prime(x):
    """x³ + A'x + B' on E'."""
    dev = x.device
    xx = fd.f2_sqr(x)
    t = fd.f2_mul(torch.stack(torch.broadcast_tensors(xx, _const(_A_PRIME,
                                                                 dev))),
                  torch.stack(torch.broadcast_tensors(x, x)))
    return fd.add(fd.add(t[0], t[1]), _const(_B_PRIME, dev))


def map_to_curve(u):
    """Fp2 values u (..., 2, 24) -> a Jacobian point (X, Y, Z, inf) on E2
    before clearing: simplified SWU onto E' (x1 = B/(Z·A) where tv = 0),
    then the selected 3-isogeny and isomorphism
    (``hash_to_curve._iso_apply``) with Z = d = x − x0, which needs no
    inversion: X = c2·(x·d² + V·d + U), Y = c3·y·(d³ − V·d − 2U); d = 0
    (a kernel point of the isogeny) is infinity. Both square roots are
    taken in one stacked call. Its affine form is ``map_to_curve_g2`` of
    the host."""
    dev = u.device
    shape = u.shape[:-2]
    one = cv.F2.one(shape, dev)
    zu2 = fd.f2_mul(_const(_Z_SSWU, dev), fd.f2_sqr(u))
    tv = fd.add(fd.f2_sqr(zu2), zu2)
    tv_zero = cv.is_zero(cv.F2, tv)
    x1_main = fd.f2_mul(_const(_MINUS_B_OVER_A, dev),
                        fd.add(one, fd.f2_inv(tv)))
    x1 = cv.select(cv.F2, tv_zero, _const(_B_OVER_ZA, dev).expand_as(x1_main),
                   x1_main)
    x2 = fd.f2_mul(zu2, x1)
    y12, sq12 = sqrt_f2(_g_prime(torch.stack([x1, x2])))
    sq1 = sq12[0]
    x = cv.select(cv.F2, sq1, x1, x2)
    y = cv.select(cv.F2, sq1, y12[0], y12[1])
    flip = sgn0_f2(u) != sgn0_f2(y)
    y = cv.select(cv.F2, flip, fd.neg(y), y)
    # 3-isogeny + isomorphism onto E2, Jacobian with Z = d
    d = fd.sub(x, _const(_ISO_X0, dev))
    vsum, usum = _const(_ISO_VSUM, dev), _const(_ISO_USUM, dev)
    d2, vd = fd.f2_mul(torch.stack(torch.broadcast_tensors(d, vsum)),
                       torch.stack([d, d])).unbind(0)
    xd2, d3 = fd.f2_mul(torch.stack([x, d2]), torch.stack([d2, d])).unbind(0)
    X = fd.add(fd.add(xd2, vd), usum)
    Y = fd.f2_mul(y, fd.sub(d3, fd.add(vd, fd.add(usum, usum))))
    c23 = torch.stack([_const(_ISO_C2, dev), _const(_ISO_C3, dev)])
    XY = fd.f2_mul(torch.stack([X, Y]),
                   c23.reshape((2,) + (1,) * len(shape) + c23.shape[1:]))
    return XY[0], XY[1], d, cv.is_zero(cv.F2, d)


def hash_to_g2_plain(u: torch.Tensor):
    """Plain version of K5: u (n, 2, 2, 12) words — two Fp2 u-values per
    message — -> (xy (n, 2, 2, 12) affine words, inf (n,) int32): map(u0)
    + map(u1), Budroni-Pintore clearing, to affine; zeros where the point
    is infinity."""
    uh = words_to_halves(u)                                 # (n, 2, 2, 24)
    p = map_to_curve(uh.movedim(1, 0))                      # (2, n, ...)
    q = cv.pt_add(cv.F2, tuple(c[0] for c in p), tuple(c[1] for c in p))
    ax, ay, inf = cv.pt_to_affine(cv.F2, cv.clear_cofactor(cv.F2, q))
    xy = torch.stack([ax, ay], dim=1)
    xy = torch.where(inf[:, None, None, None], torch.zeros_like(xy), xy)
    return halves_to_words(xy), inf.to(torch.int32)


def decompress_plain(x: torch.Tensor, sign: torch.Tensor):
    """Plain version of K6: x (n, 2, 12) words, sign (n,) int32 ->
    (xy (n, 2, 2, 12), ok (n,) int32) with ok = on_curve & in_subgroup:
    y = √(x³ + 4(1+u)) flipped to the sign flag's lexicographic choice,
    then ψ(Q) == [x]Q; zeros where ok is 0."""
    xh = words_to_halves(x)
    n = xh.shape[0]
    gx = fd.add(fd.f2_mul(fd.f2_sqr(xh), xh), _const(_B_G2, x.device))
    y, on_curve = sqrt_f2(gx)
    flip = lex_largest_f2(y) != (sign != 0)
    y = cv.select(cv.F2, flip, fd.neg(y), y)
    live = torch.zeros(n, dtype=torch.bool, device=x.device)
    in_sub = cv.subgroup_check(cv.F2, (xh, y, cv.F2.one((n,), x.device), live))
    ok = on_curve & in_sub
    xy = torch.stack([xh, y], dim=1)
    xy = torch.where(ok[:, None, None, None], xy, torch.zeros_like(xy))
    return halves_to_words(xy), ok.to(torch.int32)
