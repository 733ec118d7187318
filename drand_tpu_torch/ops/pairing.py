"""Batched BLS product check on the card: the two CUDA kernels of
``csrc/pairing.cu``, their wrappers with launch counters, and their plain
PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_pairing.py``:

- ``miller_loop`` (K1) replaces ``_miller_kernel``/``_miller_grid_kernel``;
- ``final_exp_verdict`` (K2) replaces, fused, ``_easy_*``, ``_pow_*``,
  ``_mul_frob1_*``, ``_a4_*`` and ``_is_one_*``.

A wrapper given CPU tensors runs the kernel's plain version
(``miller_loop_plain``, ``final_exp_plain``); given CUDA tensors it
launches the kernel or raises. There is no fallback between the two.

Layouts (int32 words of canonical Montgomery values, ``ops/limb.py``;
batch leading — the JAX kernels' batch-last arrays are converted by
``ops/convert.py``):

    xp, yp   (B, 2, 12)          G1 affine coordinates, one row per pair
    q        (B, 2, 2, 2, 12)    G2 affine: pair, x/y, c0/c1
    f, gt    (B, 2, 3, 2, 12)    Fp12: c0/c1 (w), Fp6 coefficient (v), Fp2
    ok       (B,)                int32, 1 iff the product is one

Pair 0 of a check is (−g1, sig) and pair 1 is (pub, H(msg)), as in
``pallas_pairing.pack_verify_inputs``. The GT value is the CUBE of the
canonical pairing product (the Hayashida chain, as
``final_exp_hard_bl`` computes it); equality with one is cube-invariant.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from ..crypto import fields as hf
from ..crypto.curves import PointG1
from ..crypto.fields import P, X_BLS
from . import f12_group as fg, field as fd
from .limb import (N0_WORD, NWORDS, ONE_MONT, R_MONT, fp_words,
                   halves_to_words, int_to_words, words_to_halves)

# ---------------------------------------------------------------------------
# Bit schedules (MSB first, zero-padded), as pallas_pairing builds them
# ---------------------------------------------------------------------------

_X_ABS = abs(X_BLS)


def _bits(e: int, skip_leading: bool, width: int) -> np.ndarray:
    s = bin(e)[2:]
    if skip_leading:
        s = s[1:]
    out = np.zeros(width, dtype=np.int32)
    out[:len(s)] = [int(c) for c in s]
    return out


MILLER_FLAGS = _bits(_X_ABS, True, 64)   # add step after doubling i
N_MILLER = _X_ABS.bit_length() - 1       # 63 doublings
BITS_X = _bits(_X_ABS, False, 64)
N_X = _X_ABS.bit_length()
BITS_XM1 = _bits(abs(X_BLS - 1), False, 64)
N_XM1 = abs(X_BLS - 1).bit_length()
PM2 = _bits(P - 2, False, 384)
N_PM2 = (P - 2).bit_length()


def kernel_consts() -> np.ndarray:
    """The constant buffer of ``csrc/fp.cuh`` (struct Consts, same order):
    counts, -p^-1 mod 2^32, p, R mod p, the Frobenius γ rows and the bit
    tables, as int32 words. Everything is computed from the host field
    code, nothing is typed in."""
    gammas = [np.stack([np.stack([int_to_words(g.c0 * R_MONT % P),
                                  int_to_words(g.c1 * R_MONT % P)])
                        for g in hf._FROBENIUS_GAMMA[k]]).reshape(-1)
              for k in (1, 2)]
    head = np.array([N_MILLER, N_X, N_XM1, N_PM2, N0_WORD, 0, 0, 0],
                    dtype=np.uint32).view(np.int32)
    return np.concatenate([head, int_to_words(P), int_to_words(ONE_MONT),
                           *gammas, MILLER_FLAGS, BITS_X, BITS_XM1, PM2])


# ---------------------------------------------------------------------------
# K1 and K2 as step tables of csrc/f12_group.cuh (ops/f12_group.py): the
# line formulas of _dbl_step, _add_step and _lines_product below
# (pairing.cu's dbl_step, add_step, lines_product), the easy part and the
# Hayashida chain of final_exp_plain, cut into programs that the kernels
# run in this order, with the loops over the bit tables between them.
# ---------------------------------------------------------------------------

def _sched_dbl_step(g, T, xp, yp):
    X, Y, Z = T
    X2, Y2, Z2 = g.sqr(X), g.sqr(Y), g.sqr(Z)
    YZ3 = g.mul(Y, g.mul(Z2, Z))
    lam = g.mul3(g.mul(X2, Z2))
    c0 = g.xi(g.mul(g.dbl(YZ3), yp))          # xi·(2·YZ3·yp)
    c5 = g.neg(g.mul(lam, xp))                # -(lam·xp)
    c3 = g.sub(g.mul3(g.mul(X2, X)), g.dbl(Y2))
    C = g.sqr(Y2)
    D = g.dbl(g.sub(g.sqr(g.add(X, Y2)), g.add(X2, C)))
    E = g.mul3(X2)
    Xn = g.sub(g.sqr(E), g.dbl(D))
    Yn = g.sub(g.mul(E, g.sub(D, Xn)), g.dbl(g.dbl(g.dbl(C))))
    Zn = g.dbl(g.mul(Y, Z))
    return (Xn, Yn, Zn), (c0, c3, c5)


def _sched_add_step(g, T, xq, yq, xp, yp):
    X, Y, Z = T
    Z2 = g.sqr(Z)
    U2 = g.mul(xq, Z2)
    S2 = g.mul(yq, g.mul(Z2, Z))
    H, M = g.sub(U2, X), g.sub(S2, Y)
    HZ = g.mul(H, Z)
    c0 = g.xi(g.mul(HZ, yp))
    c5 = g.neg(g.mul(M, xp))
    c3 = g.sub(g.mul(M, xq), g.mul(HZ, yq))
    HH = g.sqr(H)
    HHH, V = g.mul(HH, H), g.mul(X, HH)
    Xn = g.sub(g.sqr(M), g.add(HHH, g.dbl(V)))
    Yn = g.sub(g.mul(M, g.sub(V, Xn)), g.mul(Y, HHH))
    return (Xn, Yn, g.mul(Z, H)), (c0, c3, c5)


def _sched_lines_product(g, la, lb):
    pa = [la[0], la[1], la[2], g.add(la[0], la[1]), g.add(la[0], la[2]),
          g.add(la[1], la[2])]
    pb = [lb[0], lb[1], lb[2], g.add(lb[0], lb[1]), g.add(lb[0], lb[2]),
          g.add(lb[1], lb[2])]
    m = [g.mul(x, y) for x, y in zip(pa, pb)]
    w3 = g.sub(m[3], g.add(m[0], m[1]))
    w5 = g.sub(m[4], g.add(m[0], m[2]))
    w2 = g.xi(g.sub(m[5], g.add(m[1], m[2])))
    w0 = g.add(m[0], g.xi(m[1]))
    return fg.from_w([w0, g.zero, w2, w3, g.xi(m[2]), w5])


def _k1_iteration(name: str, add: bool):
    """f = f²·L(dbl), T = 2T, and on a set bit f·L(add), T = T + Q."""
    g = fg.Prog(name)
    f = g.slots("f", 6)
    T = [g.slots("t", 6)[:3], g.slots("t", 6)[3:]]
    xp, yp = g.slots("p", 4)[:2], g.slots("p", 4)[2:]
    q = g.slots("q", 4)
    xq, yq = q[0::2], q[1::2]
    f = fg.f12_sqr(g, f)
    steps = [_sched_dbl_step(g, T[j], xp[j], yp[j]) for j in range(2)]
    T = [s[0] for s in steps]
    f = fg.f12_mul(g, f, _sched_lines_product(g, steps[0][1], steps[1][1]))
    if add:
        steps = [_sched_add_step(g, T[j], xq[j], yq[j], xp[j], yp[j])
                 for j in range(2)]
        T = [s[0] for s in steps]
        f = fg.f12_mul(g, f, _sched_lines_product(g, steps[0][1],
                                                  steps[1][1]))
    g.outputs(f, "f")
    g.outputs(list(T[0]) + list(T[1]), "t")
    return g


def _k1_progs():
    init = fg.Prog("k1_init")                 # T = (Q, 1), f = 1
    q = init.slots("q", 4)
    init.outputs([q[0], q[1], init.one, q[2], q[3], init.one], "t")
    init.outputs([init.one] + [init.zero] * 5, "f")
    fin = fg.Prog("k1_fin")                   # out = conj(f): x < 0
    fin.outputs(fg.f12_conj(fin, fin.slots("f", 6)), "out")
    return [init, _k1_iteration("k1_dbl", False),
            _k1_iteration("k1_dbl_add", True), fin]


def _restart(g, src):
    """base = conj(src), acc = 1: the start of a cyc_pow_neg."""
    g.outputs(fg.f12_conj(g, src), "base")
    g.outputs([g.one] + [g.zero] * 5, "acc")


def _k2_progs():
    N = fg.NAMED
    head = fg.Prog("k2_easy_head")            # f12_inv up to Fermat
    d, terms, nrm = fg.f12_inv_head(head, head.slots("f", 6))
    head.outputs([d] + terms, "inv")
    head.output(nrm, N["norm"])
    rinit = fg.Prog("k2_recip_one")
    rinit.output(rinit.one, N["recip"])
    tail = fg.Prog("k2_easy_tail")            # f^-1, f1, m; start a1
    f = tail.slots("f", 6)
    inv = tail.slots("inv", 4)
    finv = fg.f12_inv_tail(tail, f, inv[0], inv[1:], tail.slot("recip"))
    f1 = fg.f12_mul(tail, fg.f12_conj(tail, f), finv)
    m = fg.f12_mul(tail, fg.f12_frobenius(tail, f1, 2), f1)
    tail.outputs(m, "m")
    _restart(tail, m)
    csqr = fg.Prog("k2_cyc_sqr")
    csqr.outputs(fg.f12_cyclotomic_sqr(csqr, csqr.slots("acc", 6)), "acc")
    cmul = fg.Prog("k2_cyc_mul")
    cmul.outputs(fg.f12_mul(cmul, cmul.slots("acc", 6),
                            cmul.slots("base", 6)), "acc")
    nxt = fg.Prog("k2_next")                  # a1 -> a2, a3 -> a3^-|x|
    _restart(nxt, nxt.slots("acc", 6))
    keep = fg.Prog("k2_keep")                 # a = a2
    acc = keep.slots("acc", 6)
    keep.outputs(acc, "a")
    _restart(keep, acc)
    frob = fg.Prog("k2_frob1")                # a = a2^-|x|·frob(a2, 1)
    a3 = fg.f12_mul(frob, frob.slots("acc", 6),
                    fg.f12_frobenius(frob, frob.slots("a", 6), 1))
    frob.outputs(a3, "a")
    _restart(frob, a3)
    close = fg.Prog("k2_close")               # a4·(m·cyc_sqr(m))
    a = close.slots("a", 6)
    b = fg.f12_mul(close, close.slots("acc", 6), fg.f12_frobenius(close, a, 2))
    b = fg.f12_mul(close, b, fg.f12_conj(close, a))
    m = close.slots("m", 6)
    t = fg.f12_mul(close, m, fg.f12_cyclotomic_sqr(close, m))
    close.outputs(fg.f12_mul(close, b, t), "out")
    return [head, rinit, tail, csqr, cmul, nxt, keep, frob, close]


# the programs in table order (the F12P_* enum of csrc/pairing.cu)
PROGRAMS = ("k1_init", "k1_dbl", "k1_dbl_add", "k1_fin", "k2_easy_head",
            "k2_recip_one", "k2_recip_sqr", "k2_recip_mul", "k2_easy_tail",
            "k2_cyc_sqr", "k2_cyc_mul", "k2_next", "k2_keep", "k2_frob1",
            "k2_close")

def compiled_programs() -> list:
    """K1's and K2's programs, compiled for the half-groups of a warp, in
    PROGRAMS order."""
    N = fg.NAMED
    progs = [fg.compile_prog(p) for p in _k1_progs()]
    k2 = [fg.compile_prog(p) for p in _k2_progs()]
    progs += k2[:2]
    progs.append(fg.raw_prog("k2_recip_sqr", fg.FMUL, N["recip"],
                             N["recip"], N["recip"]))
    progs.append(fg.raw_prog("k2_recip_mul", fg.FMUL, N["recip"],
                             N["recip"], N["norm"]))
    progs += k2[2:]
    assert tuple(p.name for p in progs) == PROGRAMS
    return progs


@functools.cache
def f12_tables() -> np.ndarray:
    """struct FoSched of csrc/f12_group.cuh for K1 and K2, as int32
    words."""
    return fg.pack_tables(compiled_programs())


def pairing_consts() -> np.ndarray:
    """K1's and K2's constant buffer: kernel_consts() (struct Consts),
    then their step tables (struct FoSched)."""
    return np.concatenate([kernel_consts(), f12_tables()])


_CONSTS_DEV: dict[str, torch.Tensor] = {}


def _consts_on(device, build=kernel_consts) -> torch.Tensor:
    key = f"{build.__name__}:{device}"
    t = _CONSTS_DEV.get(key)
    if t is None:
        t = torch.from_numpy(build()).to(device)
        _CONSTS_DEV[key] = t
    return t


# ---------------------------------------------------------------------------
# Plain versions (int64 half-words inside; see ops/field.py)
# ---------------------------------------------------------------------------

def _dbl_step(T, xp, yp):
    """Jacobian doubling + line (c0, c3, c5): pallas_pairing._dbl_step.
    The same products and squares as the kernel's dbl_step, grouped by
    dependency level into stacked calls."""
    X, Y, Z = T
    X2, Y2, Z2 = fd.f2_sqr(torch.stack([X, Y, Z])).unbind(0)
    Z3, X2Z2, X3cu, YZ = fd.f2_mul(torch.stack([Z2, X2, X2, Y]),
                                   torch.stack([Z, Z2, X, Z])).unbind(0)
    E = fd.mul_small(X2, 3)
    C, S, F = fd.f2_sqr(torch.stack([Y2, fd.add(X, Y2), E])).unbind(0)
    lam_s, X3cu3 = fd.mul_small(torch.stack([X2Z2, X3cu]), 3).unbind(0)
    D = fd.mul_small(fd.sub(S, fd.add(X2, C)), 2)
    Xn = fd.sub(F, fd.mul_small(D, 2))
    YZ3, EDX = fd.f2_mul(torch.stack([Y, E]),
                         torch.stack([Z3, fd.sub(D, Xn)])).unbind(0)
    l0, l5 = fd.f2_mul_fp(torch.stack([fd.mul_small(YZ3, 2), lam_s]),
                          torch.stack([yp, xp])).unbind(0)
    c0 = fd.f2_mul_by_xi(l0)
    c5 = fd.neg(l5)
    c3 = fd.sub(X3cu3, fd.mul_small(Y2, 2))
    Yn = fd.sub(EDX, fd.mul_small(C, 8))
    Zn = fd.mul_small(YZ, 2)
    return (Xn, Yn, Zn), (c0, c3, c5)


def _add_step(T, xq, yq, xp, yp):
    """Mixed addition + line: pallas_pairing._add_step."""
    X, Y, Z = T
    Z2 = fd.f2_sqr(Z)
    Z3 = fd.f2_mul(Z2, Z)
    U2 = fd.f2_mul(xq, Z2)
    S2 = fd.f2_mul(yq, Z3)
    H = fd.sub(U2, X)
    M = fd.sub(S2, Y)
    HZ = fd.f2_mul(H, Z)
    c0 = fd.f2_mul_by_xi(fd.f2_mul_fp(HZ, yp))
    c5 = fd.neg(fd.f2_mul_fp(M, xp))
    c3 = fd.sub(fd.f2_mul(M, xq), fd.f2_mul(HZ, yq))
    HH = fd.f2_sqr(H)
    HHH = fd.f2_mul(HH, H)
    V = fd.f2_mul(X, HH)
    M2 = fd.f2_sqr(M)
    Xn = fd.sub(M2, fd.add(HHH, fd.mul_small(V, 2)))
    Yn = fd.sub(fd.f2_mul(M, fd.sub(V, Xn)), fd.f2_mul(Y, HHH))
    Zn = fd.f2_mul(Z, H)
    return (Xn, Yn, Zn), (c0, c3, c5)


def _lines_product(lines):
    """Product of the two pairs' 035-sparse lines as a full Fp12:
    pallas_pairing._lines_product (6 Fp2 products)."""
    c0, c3, c5 = (x[:, 0] for x in lines)
    d0, d3, d5 = (x[:, 1] for x in lines)
    pa = torch.stack([c0, c3, c5, fd.add(c0, c3), fd.add(c0, c5),
                      fd.add(c3, c5)], dim=-3)
    pb = torch.stack([d0, d3, d5, fd.add(d0, d3), fd.add(d0, d5),
                      fd.add(d3, d5)], dim=-3)
    m0, m1, m2, m3, m4, m5 = fd.f2_mul(pa, pb).unbind(-3)
    s03 = fd.sub(m3, fd.add(m0, m1))     # w^3
    s05 = fd.sub(m4, fd.add(m0, m2))     # w^5
    s35 = fd.sub(m5, fd.add(m1, m2))     # w^8 = xi·w^2
    e0 = fd.add(m0, fd.f2_mul_by_xi(m1))
    e2 = fd.f2_mul_by_xi(s35)
    e4 = fd.f2_mul_by_xi(m2)
    return fd.f12_from_w(torch.stack(
        [e0, torch.zeros_like(e0), e2, s03, e4, s05], dim=-3))


def miller_loop_plain(xp, yp, q):
    """Plain version of K1: conj(f) of the two-pair Miller loop over |x|,
    add steps on the set bits of MILLER_FLAGS."""
    px, py = words_to_halves(xp), words_to_halves(yp)   # (B, 2, 24)
    qh = words_to_halves(q)                              # (B, 2, 2, 2, 24)
    xq, yq = qh[:, :, 0], qh[:, :, 1]                    # (B, 2, 2, 24)
    z = torch.zeros_like(xq)
    z[..., 0, :] = fd.fp_one((), xq.device)
    T = (xq, yq, z)
    f = fd.f12_one((xq.shape[0],), xq.device)
    for i in range(N_MILLER):
        f = fd.f12_sqr(f)
        T, lines = _dbl_step(T, px, py)
        f = fd.f12_mul(f, _lines_product(lines))
        if MILLER_FLAGS[i]:
            T, lines = _add_step(T, xq, yq, px, py)
            f = fd.f12_mul(f, _lines_product(lines))
    return halves_to_words(fd.f12_conj(f))


def _cyc_pow_neg(m, bits, nbits: int):
    base = fd.f12_conj(m)
    acc = fd.f12_one(m.shape[:-4], m.device)
    for i in range(nbits):
        acc = fd.f12_cyclotomic_sqr(acc)
        if bits[i]:
            acc = fd.f12_mul(acc, base)
    return acc


def final_exp_plain(f):
    """Plain version of K2: (gt, ok) — the easy part, the Hayashida chain
    (final_exp_easy_bl / final_exp_hard_bl) and the == 1 verdict."""
    fh = words_to_halves(f)
    f1 = fd.f12_mul(fd.f12_conj(fh), fd.f12_inv(fh))
    m = fd.f12_mul(fd.f12_frobenius(f1, 2), f1)
    a1 = _cyc_pow_neg(m, BITS_XM1, N_XM1)
    a2 = _cyc_pow_neg(a1, BITS_XM1, N_XM1)
    a3 = fd.f12_mul(_cyc_pow_neg(a2, BITS_X, N_X), fd.f12_frobenius(a2, 1))
    t = _cyc_pow_neg(a3, BITS_X, N_X)
    a4 = fd.f12_mul(fd.f12_mul(_cyc_pow_neg(t, BITS_X, N_X),
                               fd.f12_frobenius(a3, 2)), fd.f12_conj(a3))
    gt = fd.f12_mul(a4, fd.f12_mul(m, fd.f12_cyclotomic_sqr(m)))
    return halves_to_words(gt), fd.f12_is_one(gt).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

# Launch counts of the CUDA kernels (plain ints; a launch is counted where
# the kernel is launched, nowhere else).
LAUNCHES = {"miller_loop": 0, "final_exp_verdict": 0}

_F12_SHAPE = (2, 3, 2, NWORDS)


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


@contextlib.contextmanager
def _launch_on(t: torch.Tensor):
    """Make the card that holds ``t`` the current device for a launch and
    yield its current stream (a ctypes pointer): the C entry points copy
    constants and launch on the current device, which is otherwise the
    calling thread's, not the tensor's."""
    with torch.cuda.device(t.device):
        yield ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _kernels():
    from . import _build

    return _build.library("pairing")


def miller_loop(xp: torch.Tensor, yp: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """K1: the Miller loop of B two-pair checks -> f (B, 2, 3, 2, 12)."""
    b = xp.shape[0]
    for name, t, shape in (("xp", xp, (b, 2, NWORDS)),
                           ("yp", yp, (b, 2, NWORDS)),
                           ("q", q, (b, 2, 2, 2, NWORDS))):
        _check(name, t, shape, xp.device)
    if xp.device.type == "cpu":
        return miller_loop_plain(xp, yp, q)
    if xp.device.type != "cuda":
        raise ValueError(f"miller_loop: unsupported device {xp.device}")
    f = torch.empty((b,) + _F12_SHAPE, dtype=torch.int32, device=xp.device)
    if b == 0:
        return f
    consts = _consts_on(xp.device, pairing_consts)
    lib = _kernels()
    with _launch_on(xp) as stream:
        err = lib.miller_loop_launch(_ptr(consts), consts.numel(), _ptr(xp),
                                     _ptr(yp), _ptr(q), _ptr(f), b, stream)
    _raise_on(err, "miller_loop_kernel")
    LAUNCHES["miller_loop"] += 1
    return f


def final_exp_verdict(f: torch.Tensor):
    """K2: final exponentiation + verdict -> (gt (B, 2, 3, 2, 12), ok (B,))."""
    b = f.shape[0]
    _check("f", f, (b,) + _F12_SHAPE, f.device)
    if f.device.type == "cpu":
        return final_exp_plain(f)
    if f.device.type != "cuda":
        raise ValueError(f"final_exp_verdict: unsupported device {f.device}")
    gt = torch.empty_like(f)
    ok = torch.empty((b,), dtype=torch.int32, device=f.device)
    if b == 0:
        return gt, ok
    consts = _consts_on(f.device, pairing_consts)
    lib = _kernels()
    with _launch_on(f) as stream:
        err = lib.final_exp_verdict_launch(_ptr(consts), consts.numel(),
                                           _ptr(f), _ptr(gt), _ptr(ok), b,
                                           stream)
    _raise_on(err, "final_exp_verdict_kernel")
    LAUNCHES["final_exp_verdict"] += 1
    return gt, ok


# ---------------------------------------------------------------------------
# The product check on engine-packed inputs
# ---------------------------------------------------------------------------

_NEG_G1: np.ndarray | None = None


def neg_g1_words() -> np.ndarray:
    """(2, 12) int32: affine −g1, the first pair's G1 point."""
    global _NEG_G1
    if _NEG_G1 is None:
        x, y = (-PointG1.generator()).to_affine()
        _NEG_G1 = np.stack([fp_words(x.v), fp_words(y.v)])
    return _NEG_G1


def pack_verify_inputs(pub_aff, sig_aff, msg_aff):
    """Engine arrays pub (B, 2, 12) [x/y], sig/msg (B, 2, 2, 12) -> the
    kernel inputs xp, yp (B, 2, 12) and q (B, 2, 2, 2, 12), pair 0 =
    (−g1, sig), pair 1 = (pub, msg); on the device of ``pub_aff``."""
    b = pub_aff.shape[0]
    ng = torch.from_numpy(neg_g1_words()).to(pub_aff.device)
    xp = torch.stack([ng[0].expand(b, NWORDS), pub_aff[:, 0]], dim=1)
    yp = torch.stack([ng[1].expand(b, NWORDS), pub_aff[:, 1]], dim=1)
    q = torch.stack([sig_aff, msg_aff], dim=1)
    return xp.contiguous(), yp.contiguous(), q.contiguous()


def verify_prepared(pub_aff, sig_aff, msg_aff) -> torch.Tensor:
    """(B,) bool: e(−g1, sig)·e(pub, msg) == 1 per row, through K1 and K2
    (their plain versions for CPU tensors)."""
    f = miller_loop(*pack_verify_inputs(pub_aff, sig_aff, msg_aff))
    return final_exp_verdict(f)[1] != 0


def verify_prepared_plain(pub_aff, sig_aff, msg_aff) -> torch.Tensor:
    """verify_prepared through the plain versions, on any device."""
    f = miller_loop_plain(*pack_verify_inputs(pub_aff, sig_aff, msg_aff))
    return final_exp_plain(f)[1] != 0
