"""A CPU model of K5's cooperative field arithmetic (``csrc/fp_group.cuh``),
held exactly against the port's plain Fp product (``ops/field.py``), the
JAX package's host field oracle and its limb field product
(``drand_tpu.ops.limb.mont_mul``).

The model is numpy over a batch of values and follows the CUDA code step
for step, with the same word split: the four threads of a half-group at
lanes ``lead`` .. ``lead + 3`` of a warp, thread k holding words 3k ..
3k+2 of every value; the shuffles that broadcast b's words and m, the
one-word shift down through the thread below, the carry word kept beside
each slice, and the carry lookahead over the half-group's ballots that
resolves carries and borrows. A carry error shows here before the card
runs the kernel. Tolerance zero."""

import random

import jax
import numpy as np
import pytest
import torch

from drand_tpu.crypto import fields as jf
from drand_tpu.ops import limb as jlimb
from drand_tpu_torch.ops import field as fd, limb as L

torch.set_num_threads(1)

GT, GW = 4, 3                        # threads per value, words per thread
M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
P = jf.P
R = 1 << 384
R_INV = pow(R, -1, P)
N0 = np.uint64((-pow(P, -1, 1 << 32)) % (1 << 32))
EDGE_STORED = [0, 1, P - 1, P - 2, 1 << 380,
               (1 << 352) - 1 + (0x1A0111E9 << 352)]
# slices of all ones: a carry into thread 0 ripples through the others
RIPPLE = [(1 << (96 * k)) - 1 for k in (1, 2, 3)] + [(1 << 96) + 1]


def _operands(seed):
    """test_torch_field's inputs (random stored values, then its edge
    values), with R mod p and the ripple values; ys reversed."""
    rng = random.Random(seed)
    xs = [rng.randrange(P) for _ in range(24)] + EDGE_STORED
    xs += [R % P] + RIPPLE
    return xs, list(reversed(xs))


def _slices(vals) -> np.ndarray:
    """(B, GT, GW) uint64: thread k's words 3k .. 3k+2 of each value."""
    words = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
                      for v in vals], dtype=np.uint64)
    return words.reshape(len(vals), GT, GW)


def _ints(sl: np.ndarray) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row))
            for row in sl.reshape(sl.shape[0], 12)]


P_SL = _slices([P])[0]               # (GT, GW): each thread's words of p
K = np.arange(GT)


def _carry_in(g, prop, lead):
    """fg_carry_in_n: the ballots G (generate) and P (propagate) over the
    half-group's lanes, s = (G << 1) + P; the carry into thread k is bit
    lead + k of s ^ P, the carry out of the value bit lead + 4 of s."""
    assert not (g & prop).any(), "a slice both generates and propagates"
    shift = (lead + K).astype(np.uint64)
    G = (g.astype(np.uint64) << shift).sum(axis=1)
    Pm = (prop.astype(np.uint64) << shift).sum(axis=1)
    s = (G << np.uint64(1)) + Pm
    top = (s >> np.uint64(lead + GT)) & np.uint64(1)
    cin = ((s ^ Pm)[:, None] >> shift) & np.uint64(1)
    return cin, top


def _all_ones(x):
    return (x == M32).all(axis=2)


def _slice_zero(x):
    return (x == 0).all(axis=2)


def _inc(x, c):
    """fg_inc: slice + c (c in {0, 1}) within each thread."""
    x = x.copy()
    for v in range(GW):
        s = x[:, :, v] + c
        x[:, :, v] = s & M32
        c = s >> S32
    return x


def _dec(x, b):
    """fg_dec: slice − b (b in {0, 1}) within each thread."""
    x = x.copy()
    for v in range(GW):
        o = x[:, :, v].copy()
        x[:, :, v] = (o - b) & M32
        b = b & (o == 0)
    return x


def _reduce_once(s, lead):
    """fg_reduce_once_n: s − p where s >= p, else s (s < 2p)."""
    d = np.zeros_like(s)
    br = np.zeros(s.shape[:2], np.uint64)
    for v in range(GW):
        t = s[:, :, v] - P_SL[:, v] - br           # wraps where negative
        d[:, :, v] = t & M32
        br = t >> np.uint64(63)
    cin, lt = _carry_in(br, _slice_zero(d), lead)
    d = _dec(d, cin)
    return np.where(lt[:, None, None] != 0, s, d)


def _add(a, b, lead):
    """fg_add_n: local sums, carries resolved by lookahead, one reduction."""
    s = np.zeros_like(a)
    c = np.zeros(a.shape[:2], np.uint64)
    for v in range(GW):
        c = c + a[:, :, v] + b[:, :, v]
        s[:, :, v] = c & M32
        c = c >> S32
    cin, top = _carry_in(c, _all_ones(s), lead)
    assert not top.any()
    return _reduce_once(_inc(s, cin), lead)


def _sub(a, b, lead):
    """fg_sub_n: local differences, borrows by lookahead, then p added back
    (masked to zero unless negative); the carry out is the 2^384 wrap."""
    d = np.zeros_like(a)
    br = np.zeros(a.shape[:2], np.uint64)
    for v in range(GW):
        t = a[:, :, v] - b[:, :, v] - br
        d[:, :, v] = t & M32
        br = t >> np.uint64(63)
    bin_, neg = _carry_in(br, _slice_zero(d), lead)
    d = _dec(d, bin_)
    mask = (np.uint64(0) - neg) & M32
    r = np.zeros_like(a)
    c = np.zeros(a.shape[:2], np.uint64)
    for v in range(GW):
        c = c + d[:, :, v] + (P_SL[:, v] & mask[:, None])
        r[:, :, v] = c & M32
        c = c >> S32
    cin, _ = _carry_in(c, _all_ones(r), lead)
    return _inc(r, cin)


def _mul(a, b, lead, trace=None):
    """fg_mul_n for one product: CIOS over b's 12 words, word i of b from
    thread i // 3; m from thread 0's exact lowest word; each thread adds
    a·b_i and m·p to its three words with the carry out kept in hi (the
    word above its slice); the shift takes thread k+1's lowest word into
    thread k's top word. Then hi of thread k−1 comes up, the carries are
    resolved by lookahead and p is subtracted once. ``trace`` collects
    (the represented value, max hi) after every step."""
    B = a.shape[0]
    t = np.zeros((B, GT, GW), np.uint64)
    hi = np.zeros((B, GT), np.uint64)
    for j in range(GT):
        for w in range(GW):
            bi = np.broadcast_to(b[:, j, w][:, None], (B, GT))    # shfl j
            c = np.zeros((B, GT), np.uint64)
            for v in range(GW):
                c = c + a[:, :, v] * bi + t[:, :, v]
                t[:, :, v] = c & M32
                c = c >> S32
            hi = hi + c
            m = (t[:, 0, 0] * N0) & M32                              # shfl 0
            c = np.zeros((B, GT), np.uint64)
            for v in range(GW):
                c = c + m[:, None] * P_SL[:, v] + t[:, :, v]
                t[:, :, v] = c & M32
                c = c >> S32
            hi = hi + c
            assert not t[:, 0, 0].any()       # the lowest word is now zero
            up = np.concatenate([t[:, 1:, 0], t[:, -1:, 0]], axis=1)  # down 1
            s = hi + np.where(K == GT - 1, np.uint64(0), up)
            t = np.concatenate([t[:, :, 1:], (s & M32)[:, :, None]], axis=2)
            hi = s >> S32
            if trace is not None:
                val = [_ints(t[i:i + 1])[0]
                       + sum(int(hi[i, k]) << (32 * GW * (k + 1))
                             for k in range(GT)) for i in range(B)]
                trace.append((val, int(hi.max())))
    hin = np.concatenate([hi[:, :1], hi[:, :-1]], axis=1)           # up 1
    s = np.zeros_like(t)
    c = np.where(K == 0, np.uint64(0), hin)
    for v in range(GW):
        c = c + t[:, :, v]
        s[:, :, v] = c & M32
        c = c >> S32
    cin, top = _carry_in(c, _all_ones(s), lead)
    assert not top.any()
    return _reduce_once(_inc(s, cin), lead)


def _stored(vals) -> torch.Tensor:
    words = np.stack([L.int_to_words(v) for v in vals])
    return L.words_to_halves(torch.from_numpy(words))


def _read(t: torch.Tensor) -> list[int]:
    return [L.words_to_int(w)
            for w in L.halves_to_words(t).numpy().reshape(-1, 12)]


@pytest.fixture(scope="module")
def jax_products():
    """The JAX package's limb product on the product's inputs, reduced."""
    xs, ys = _operands("mont_mul")
    a = np.stack([jlimb.int_to_limbs(x) for x in xs])
    b = np.stack([jlimb.int_to_limbs(y) for y in ys])
    out = np.asarray(jax.jit(jlimb.mont_mul)(a, b))
    return [jlimb.limbs_to_int(r) % P for r in out]


@pytest.mark.parametrize("lead", [0, 28])
def test_group_product_matches_port_and_jax(lead, jax_products):
    """Lanes 0-3 and 28-31 (the ballot's top bits): every product equals
    the port's plain product, the JAX limb product and the host oracle."""
    xs, ys = _operands("mont_mul")
    got = _ints(_mul(_slices(xs), _slices(ys), lead))
    assert got == _read(fd.mont_mul(_stored(xs), _stored(ys)))
    assert got == jax_products
    assert got == [jf.fp_mul(jf.fp_mul(x, y), R_INV) for x, y in zip(xs, ys)]


def test_group_product_steps_are_cios():
    """After each of the 12 steps the slices and the carry words beside
    them hold exactly the one-thread CIOS accumulator, and the carry words
    stay at most 2 (so 32 bits carry them up at the end)."""
    xs, ys = _operands("steps")
    trace = []
    _mul(_slices(xs[:8]), _slices(ys[:8]), 4, trace)
    n0 = int(N0)
    for i, (x, y) in enumerate(zip(xs[:8], ys[:8])):
        t = 0
        for step in range(12):
            t += x * ((y >> (32 * step)) & 0xFFFFFFFF)
            m = (t & 0xFFFFFFFF) * n0 & 0xFFFFFFFF
            t = (t + m * P) >> 32
            assert trace[step][0][i] == t
    assert max(h for _, h in trace) <= 2


@pytest.mark.parametrize("op", ["add", "sub"])
def test_group_add_sub_match_port_and_host(op):
    """The carry and borrow lookahead of fg_add / fg_sub, with slices of
    all ones and all zeros that pass a carry through every thread."""
    xs, ys = _operands(op)
    ys = ys + [1, 1, 1, (1 << 288) - 1]
    xs = xs + RIPPLE[:3] + [1]
    fn, port, host = {"add": (_add, fd.add, jf.fp_add),
                      "sub": (_sub, fd.sub, jf.fp_sub)}[op]
    for lead in (0, 28):
        got = _ints(fn(_slices(xs), _slices(ys), lead))
        assert got == _read(port(_stored(xs), _stored(ys)))
        assert got == [host(x, y) for x, y in zip(xs, ys)]
