"""The port's plain Fp..Fp12 arithmetic (drand_tpu_torch.ops.field) and
limb packing, held exactly against the JAX package: its host field
oracle ``drand_tpu.crypto.fields``, its batch-last kernel tower
``drand_tpu.ops.bl`` (two of its primitives, jitted) and its limb format
``ops.limb``.

Finite-field values: every comparison is exact (tolerance zero)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto import fields as jf
from drand_tpu.ops import bl
from drand_tpu.ops import limb as jlimb
from drand_tpu_torch.ops import convert, field as fd, limb as L

# The plain versions run thousands of tiny tensor ops: one intra-op thread
# per test worker, or six workers' thread pools thrash the cores.
torch.set_num_threads(1)

P = jf.P
R_INV = pow(1 << 384, -1, P)

# stored (Montgomery) values the JAX package pins as adversarial: zero,
# one, p-1 (max magnitude), p-2, a power of two near the top, a value
# whose words are all ones below p's top word
EDGE_STORED = [0, 1, P - 1, P - 2, 1 << 380,
               (1 << 352) - 1 + (0x1A0111E9 << 352)]


def _stored(vals, shape=None) -> torch.Tensor:
    """Stored Montgomery ints -> (..., 24) half-words."""
    words = np.stack([L.int_to_words(v) for v in vals])
    t = L.words_to_halves(torch.from_numpy(words))
    return t if shape is None else t.reshape(tuple(shape) + (24,))


def _read(t: torch.Tensor) -> list[int]:
    words = L.halves_to_words(t).numpy().reshape(-1, 12)
    return [L.words_to_int(w) for w in words]


def _rand_stored(rng, n):
    return [rng.randrange(P) for _ in range(n)] + EDGE_STORED


# Montgomery semantics: stored s represents s·R^-1; a product of stored
# values is s_a·s_b·R^-1, a sum is a sum, an inverse is R^2·s^-1.
_FP_CASES = {
    "mont_mul": (fd.mont_mul, lambda a, b: jf.fp_mul(jf.fp_mul(a, b), R_INV)),
    "add": (fd.add, jf.fp_add),
    "sub": (fd.sub, jf.fp_sub),
    "neg": (lambda a, b: fd.neg(a), lambda a, b: jf.fp_neg(a)),
    "mul_small_8": (lambda a, b: fd.mul_small(a, 8),
                    lambda a, b: jf.fp_mul(a, 8)),
}


@pytest.mark.parametrize("op", sorted(_FP_CASES))
def test_fp_ops_match_host(op):
    rng = random.Random(op)
    xs = _rand_stored(rng, 24)
    ys = list(reversed(_rand_stored(rng, 24)))
    fn, ref = _FP_CASES[op]
    got = _read(fn(_stored(xs), _stored(ys)))
    assert got == [ref(x, y) for x, y in zip(xs, ys)]


def test_fp_inv_matches_host():
    rng = random.Random(7)
    xs = [rng.randrange(1, P) for _ in range(3)] + [1, P - 1]
    got = _read(fd.fp_inv(_stored(xs)))
    # stored s -> value s/R; its inverse R/s is stored as R^2/s
    r2 = pow(1 << 384, 2, P)
    assert got == [jf.fp_mul(r2, jf.fp_inv(x)) for x in xs]


def test_chained_ops_match_host():
    """Long chains of dependent operations on one batch (the
    content-varied chained fuzz of tests/test_limb_regression.py)."""
    rng = random.Random(11)
    n = 16
    vals = _rand_stored(rng, n - len(EDGE_STORED))
    a, ref = _stored(vals), list(vals)
    b_vals = _rand_stored(rng, n - len(EDGE_STORED))
    b = _stored(b_vals)
    for step in range(60):
        op = ("mont_mul", "add", "sub", "neg")[step % 4]
        fn, rf = _FP_CASES[op]
        a = fn(a, b)
        ref = [rf(x, y) for x, y in zip(ref, b_vals)]
        if step % 7 == 0:           # feed the chain back into the operand
            b, b_vals = a, list(ref)
    assert _read(a) == ref


# ---------------------------------------------------------------------------
# tower: against drand_tpu.crypto.fields.Fp2/Fp6/Fp12 (canonical values)
# ---------------------------------------------------------------------------

def _rand_f12(rng):
    return jf.Fp12(*[jf.Fp6(*[jf.Fp2(rng.randrange(P), rng.randrange(P))
                              for _ in range(3)]) for _ in range(2)])


def _f12_ints(x):
    return [c for c6 in (x.c0, x.c1) for c2 in (c6.c0, c6.c1, c6.c2)
            for c in (c2.c0, c2.c1)]


def _to_port(xs) -> torch.Tensor:
    """Host Fp12 list -> (B, 2, 3, 2, 24) Montgomery half-words."""
    words = L.pack_ints([_f12_ints(x) for x in xs], (len(xs), 2, 3, 2))
    return L.words_to_halves(words)


def _from_port(t: torch.Tensor):
    vals = L.unpack_ints(L.halves_to_words(t)).reshape(-1, 12)
    out = []
    for v in vals:
        c2 = [jf.Fp2(int(v[2 * i]), int(v[2 * i + 1])) for i in range(6)]
        out.append(jf.Fp12(jf.Fp6(*c2[:3]), jf.Fp6(*c2[3:])))
    return out


def _cyclotomic(x):
    """The easy part of the final exponentiation lands in the cyclotomic
    subgroup, where Granger–Scott squaring is the square."""
    f1 = x.conjugate() * x.inverse()
    return f1.frobenius(2) * f1


_F12_CASES = {
    "f12_mul": (lambda a, b: fd.f12_mul(a, b), lambda a, b: a * b),
    "f12_sqr": (lambda a, b: fd.f12_sqr(a), lambda a, b: a.square()),
    "f12_conj": (lambda a, b: fd.f12_conj(a), lambda a, b: a.conjugate()),
    "f12_inv": (lambda a, b: fd.f12_inv(a), lambda a, b: a.inverse()),
    "f12_frobenius_1": (lambda a, b: fd.f12_frobenius(a, 1),
                        lambda a, b: a.frobenius(1)),
    "f12_frobenius_2": (lambda a, b: fd.f12_frobenius(a, 2),
                        lambda a, b: a.frobenius(2)),
}


@pytest.mark.parametrize("op", sorted(_F12_CASES))
def test_f12_ops_match_host(op):
    rng = random.Random(op)
    xs = [_rand_f12(rng) for _ in range(2)]
    ys = [_rand_f12(rng) for _ in range(2)]
    fn, ref = _F12_CASES[op]
    got = _from_port(fn(_to_port(xs), _to_port(ys)))
    assert got == [ref(x, y) for x, y in zip(xs, ys)]


def test_cyclotomic_sqr_matches_host_square():
    rng = random.Random(5)
    xs = [_cyclotomic(_rand_f12(rng)) for _ in range(2)]
    got = _from_port(fd.f12_cyclotomic_sqr(_to_port(xs)))
    assert got == [x.square() for x in xs]
    assert got == [x.cyclotomic_square() for x in xs]


def test_f12_is_one():
    rng = random.Random(3)
    xs = [jf.Fp12.one(), _rand_f12(rng), jf.Fp12.zero()]
    assert fd.f12_is_one(_to_port(xs)).tolist() == [True, False, False]


# ---------------------------------------------------------------------------
# against the JAX kernel tower ops/bl.py
# ---------------------------------------------------------------------------

def _to_bl(xs) -> np.ndarray:
    """Host Fp12 list -> bl's batch-last (2, 3, 2, 32, B) limbs."""
    arr = np.stack([np.stack([jlimb.int_to_mont_limbs(v)
                              for v in _f12_ints(x)]).reshape(2, 3, 2, 32)
                    for x in xs])
    return np.moveaxis(arr, 0, -1)


@pytest.fixture(scope="module")
def bl_inputs():
    """Cyclotomic xs and random ys at B = 2, host values and bl limbs (on
    cyclotomic inputs both ops are squares and products of the same field
    elements)."""
    rng = random.Random(2026)
    xs = [_cyclotomic(_rand_f12(rng)) for _ in range(2)]
    ys = [_rand_f12(rng) for _ in range(2)]
    return xs, ys, jnp.asarray(_to_bl(xs)), jnp.asarray(_to_bl(ys))


# bl's op under jax.jit: one small compiled graph per case, far cheaper
# on the CPU than dispatching its thousands of eager primitives
_BL_OPS = {
    "f12_mul": lambda a, b: bl.f12_mul(a, b),
    "f12_cyclotomic_sqr": lambda a, b: bl.f12_cyclotomic_sqr(a),
}


@pytest.mark.parametrize("op", sorted(_BL_OPS))
def test_f12_primitives_match_jax_bl(bl_inputs, op):
    xs, ys, ja, jb = bl_inputs
    theirs = convert.f12_from_jax(np.asarray(jax.jit(_BL_OPS[op])(ja, jb)))
    a, b = _to_port(xs), _to_port(ys)
    mine = fd.f12_mul(a, b) if op == "f12_mul" else fd.f12_cyclotomic_sqr(a)
    assert torch.equal(L.halves_to_words(mine), theirs)  # lazily reduced limbs


# ---------------------------------------------------------------------------
# limb formats
# ---------------------------------------------------------------------------

def test_from_jax_limbs_lazy_values():
    """JAX limbs of values in [p, 2^384) with limbs above 12 bits (the
    engine invariant allows up to ~4100) land on the canonical value."""
    rng = np.random.default_rng(9)
    rows, want = [], []
    while len(rows) < 64:
        limbs = rng.integers(0, 4101, size=32)
        v = jlimb.limbs_to_int(limbs)
        if P <= v < 1 << 384:
            rows.append(limbs.astype(np.int32))
            want.append(v % P)
    rows.append(np.asarray(jlimb.int_to_limbs(P - 1), np.int32))
    want.append(P - 1)
    got = convert.from_jax_limbs(np.stack(rows))
    assert [L.words_to_int(w) for w in got.numpy()] == want
    # and back: canonical JAX limbs of the same value
    back = convert.to_jax_limbs(got)
    assert [jlimb.limbs_to_int(r) for r in back] == want
    assert back.max() <= jlimb.MASK


def test_jax_host_packing_round_trip():
    """The JAX package's host packing and the port's agree on the same
    Montgomery integer: fp_from_device(to_jax_limbs(fp_words(x))) == x."""
    rng = random.Random(4)
    xs = [rng.randrange(P) for _ in range(8)] + [0, 1, P - 1]
    words = L.pack_ints(xs, (len(xs),))
    assert L.unpack_ints(words).tolist() == xs
    jl = convert.to_jax_limbs(words)
    assert [jlimb.fp_from_device(r) for r in jl] == xs
    assert torch.equal(convert.from_jax_limbs(
        np.stack([jlimb.int_to_mont_limbs(x) for x in xs])), words)


def test_words_halves_round_trip():
    vals = [0, 1, P - 1, (1 << 384) - 1, 0x80000000 << 64]
    words = torch.from_numpy(np.stack([L.int_to_words(v) for v in vals]))
    halves = L.words_to_halves(words)
    assert halves.dtype == torch.int64 and halves.max() < 1 << 16
    assert torch.equal(L.halves_to_words(halves), words)
    assert [L.words_to_int(w) for w in words.numpy()] == vals
