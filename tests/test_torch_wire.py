"""The wire path's plain versions (ops/h2c.py, the G2 maps of ops/curve.py)
held exactly to the JAX package on the same seeded inputs.

The byte prep (``msgs_to_u``, ``sigs_to_x``) is plain numpy in both
packages, so the port is compared with the JAX functions directly,
through ``ops/convert.py``'s limb re-packing. The device functions of
``bl_h2c`` (the Pallas kernels' arithmetic) are NOT called here: their
own CPU goldens take 88.1 s (``test_hash_to_g2_matches_host``, B = 4)
and 33.1 s (``test_decompress_and_subgroup_matches_host``) on one core,
more than this suite can spend. Those goldens hold ``bl_h2c`` to the
host oracle — ``drand_tpu.crypto.hash_to_curve`` and
``PointG2.from_bytes`` — so this file holds the port to the same oracle
on the same inputs: equal to the oracle, the two are equal to each
other. The ψ maps, [x]P, Scott's check and Budroni-Pintore clearing are
held to ``drand_tpu.crypto.endo``. No JAX graph is built."""

import random

import numpy as np
import pytest
import torch

from drand_tpu.crypto import curves as jcurves
from drand_tpu.crypto import endo as jendo
from drand_tpu.crypto import hash_to_curve as jhtc
from drand_tpu.crypto.fields import Fp2 as JFp2
from drand_tpu.ops import h2c as jh2c
from drand_tpu_torch.crypto.curves import PointG2
from drand_tpu_torch.crypto.fields import P, R, X_BLS
from drand_tpu_torch.ops import convert, h2c
from drand_tpu_torch.ops import curve as cv
from drand_tpu_torch.ops.limb import (fp_from_words, fp_words,
                                      halves_to_words, words_to_halves,
                                      words_to_int)

torch.set_num_threads(1)

B_G2 = JFp2(4, 4)


def _f2_host(w) -> tuple[int, int]:
    """(2, 12) words -> (c0, c1) canonical ints."""
    return fp_from_words(w[0]), fp_from_words(w[1])


def _f2_words(c0: int, c1: int) -> np.ndarray:
    return np.stack([fp_words(c0), fp_words(c1)])


def _xy_host(xy) -> tuple:
    """(2, 2, 12) affine words -> ((x.c0, x.c1), (y.c0, y.c1))."""
    return _f2_host(xy[0]), _f2_host(xy[1])


def _jaff(pt) -> tuple:
    """A JAX-package host point -> the same tuple, or None at infinity."""
    if pt.is_infinity():
        return None
    x, y = pt.to_affine()
    return (x.c0, x.c1), (y.c0, y.c1)


def _port_points(points):
    """JAX host G2 points (none at infinity) -> plain Jacobian tensors,
    Z = 1."""
    rows = []
    for pt in points:
        x, y = pt.to_affine()
        rows.append(np.stack([_f2_words(x.c0, x.c1), _f2_words(y.c0, y.c1)]))
    w = words_to_halves(torch.from_numpy(np.stack(rows)))
    n = len(points)
    return (w[:, 0], w[:, 1], cv.F2.one((n,), "cpu"),
            torch.zeros(n, dtype=torch.bool))


def _affine_rows(p) -> list:
    ax, ay, inf = cv.pt_to_affine(cv.F2, p)
    xy = halves_to_words(torch.stack([ax, ay], dim=1)).numpy()
    return [None if inf[i] else _xy_host(xy[i]) for i in range(len(inf))]


# ---------------------------------------------------------------------------
# host byte prep against the JAX package's
# ---------------------------------------------------------------------------

MSGS = [b"", b"drand", b"\x00" * 40, bytes(range(256)) * 3]


def test_msgs_to_u_matches_jax():
    for dst in (jhtc.DEFAULT_DST_G2, b"QUUX-V01-CS02-with-test-dst"):
        got = torch.from_numpy(h2c.msgs_to_u(MSGS, dst))
        want = convert.from_jax_limbs(jh2c.msgs_to_u(MSGS, dst))
        assert got.shape == (len(MSGS), 2, 2, 12)
        assert torch.equal(got, want)


def _sig(seed: int, sign: int) -> bytes:
    """A valid compressed signature whose sort flag is ``sign``."""
    rng = random.Random(seed)
    while True:
        b = jcurves.PointG2.generator().mul(rng.randrange(1, R)).to_bytes()
        if bool(b[0] & 0x20) == bool(sign):
            return b


def _with_x(sig: bytes, c1: int | None = None, c0: int | None = None):
    b = bytearray(sig)
    if c1 is not None:
        b[:48] = c1.to_bytes(48, "big")
        b[0] |= sig[0] & 0xE0
    if c0 is not None:
        b[48:] = c0.to_bytes(48, "big")
    return bytes(b)


HEADER_CASES = {
    "sign_0": lambda: _sig(1, 0),
    "sign_1": lambda: _sig(2, 1),
    "short": lambda: _sig(3, 0)[:95],
    "long": lambda: _sig(3, 0) + b"\x00",
    "uncompressed": lambda: bytes([_sig(4, 0)[0] & 0x7F]) + _sig(4, 0)[1:],
    "infinity_bit": lambda: bytes([_sig(5, 0)[0] | 0x40]) + _sig(5, 0)[1:],
    "infinity": lambda: bytes([0xC0]) + b"\x00" * 95,
    "c0_eq_p": lambda: _with_x(_sig(6, 0), c0=P),
    "c0_max": lambda: _with_x(_sig(6, 1), c0=(1 << 384) - 1),
    "c1_eq_p": lambda: _with_x(_sig(7, 0), c1=P),
    "c1_p_plus_1": lambda: _with_x(_sig(7, 1), c1=P + 1),
    "c0_p_minus_1": lambda: _with_x(_sig(8, 0), c0=P - 1),
}


@pytest.mark.parametrize("case", sorted(HEADER_CASES))
def test_sigs_to_x_matches_jax(case):
    sig = HEADER_CASES[case]()
    xs, sign, valid = h2c.sigs_to_x([sig, _sig(9, 1)])
    jxs, jsign, jvalid = jh2c.sigs_to_x([sig, _sig(9, 1)])
    assert torch.equal(torch.from_numpy(xs), convert.from_jax_limbs(jxs))
    assert sign.tolist() == jsign.tolist()
    assert valid.tolist() == jvalid.tolist()
    assert valid[1] and sign[1]
    want_valid = case in ("sign_0", "sign_1", "c0_p_minus_1")
    assert bool(valid[0]) == want_valid
    if not want_valid:
        assert not xs[0].any() and not sign[0]


def test_pad_sig_is_the_generator():
    assert h2c.pad_sig() == PointG2.generator().to_bytes()
    _, _, valid = h2c.sigs_to_x([h2c.pad_sig()])
    assert valid.tolist() == [True]


def test_kernel_constant_buffer_layout():
    """h2c_consts() in the order and size of struct H2cConsts."""
    c = h2c.h2c_consts()
    assert c.dtype == np.int32
    assert c.shape == (4 + 12 + 19 * 24 + h2c.SQRT_BITS_WIDTH,)
    assert c[0] == ((P * P + 7) // 16).bit_length()
    bits = c[-h2c.SQRT_BITS_WIDTH:][:c[0]]
    assert int("".join(map(str, bits.tolist())), 2) == (P * P + 7) // 16
    assert not c[-h2c.SQRT_BITS_WIDTH:][c[0]:].any()
    assert words_to_int(c[4:16]) == (P - 1) // 2
    assert _f2_host(c[16:40].reshape(2, 12)) == (0, 240)      # A'


# ---------------------------------------------------------------------------
# field helpers against the host
# ---------------------------------------------------------------------------

def _fp2_values():
    rng = random.Random(21)
    vals = [(0, 0), (1, 0), (0, 1), (P - 1, 0), (0, P - 1), (2, 0), (0, 2),
            ((P - 1) // 2, 0), ((P + 1) // 2, 0), (0, (P - 1) // 2),
            (0, (P + 1) // 2), (5, (P + 1) // 2)]
    vals += [(rng.randrange(P), 0) for _ in range(3)]
    vals += [(0, rng.randrange(P)) for _ in range(3)]
    vals += [(rng.randrange(P), rng.randrange(P)) for _ in range(6)]
    return vals


def test_sgn0_and_lex_largest_match_host():
    vals = _fp2_values()
    a = words_to_halves(torch.from_numpy(np.stack([_f2_words(*v)
                                                   for v in vals])))
    sgn = h2c.sgn0_f2(a).tolist()
    lex = h2c.lex_largest_f2(a).tolist()
    for v, s, lx in zip(vals, sgn, lex):
        assert s == bool(JFp2(*v).sgn0()), v
        y = JFp2(*v)
        assert lx == ((y.c1, y.c0) > ((-y).c1, (-y).c0)), v


# ---------------------------------------------------------------------------
# G2 maps against drand_tpu.crypto.endo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def e2_points():
    """Points on E2: three outside G2 (single SSWU maps), three in G2
    (generator multiples), and a pair P, −P."""
    rng = random.Random(31)
    off = [jhtc.map_to_curve_g2(JFp2(rng.randrange(P), rng.randrange(P)))
           for _ in range(3)]
    g = jcurves.PointG2.generator()
    on = [g.mul(rng.randrange(1, R)) for _ in range(3)]
    return off + on


def test_psi_and_psi2_match_host(e2_points):
    p = _port_points(e2_points)
    assert _affine_rows(cv.psi(p)) == [_jaff(jendo.psi(q))
                                       for q in e2_points]
    assert _affine_rows(cv.psi2(p)) == [_jaff(jendo.psi2(q))
                                        for q in e2_points]


def test_mul_x_and_subgroup_check_match_host(e2_points):
    p = _port_points(e2_points)
    assert _affine_rows(cv.mul_x(cv.F2, p)) == [
        _jaff(jendo._mul_int(q, X_BLS)) for q in e2_points]
    got = cv.subgroup_check(cv.F2, p).tolist()
    want = [jendo.subgroup_check_fast(q) for q in e2_points]
    assert got == want == [False] * 3 + [True] * 3
    inf = tuple(c.clone() for c in p[:3]) + (torch.ones(6, dtype=torch.bool),)
    assert cv.subgroup_check(cv.F2, inf).tolist() == [True] * 6


def test_clear_cofactor_matches_host(e2_points):
    p = _port_points(e2_points)
    got = _affine_rows(cv.clear_cofactor(cv.F2, p))
    want = [_jaff(jendo.clear_cofactor_fast(q)) for q in e2_points]
    assert got == want
    assert want[:3] == [_jaff(q.mul(jhtc._H_CLEAR)) for q in e2_points[:3]]


# ---------------------------------------------------------------------------
# map_to_curve, hash_to_g2_plain, decompress_plain against the host oracle
# ---------------------------------------------------------------------------

def test_map_to_curve_matches_host():
    """u = 0 (tv = 0: the B/(Z·A) branch) and random u, in one call."""
    rng = random.Random(41)
    us = [(0, 0)] + [(rng.randrange(P), rng.randrange(P)) for _ in range(3)]
    u = words_to_halves(torch.from_numpy(np.stack([_f2_words(*v)
                                                   for v in us])))
    got = _affine_rows(h2c.map_to_curve(u))
    assert got == [_jaff(jhtc.map_to_curve_g2(JFp2(*v))) for v in us]


def test_hash_to_g2_plain_matches_host():
    msgs = [b"", b"round-1", b"\xff" * 33, b"drand-torch-wire"]
    xy, inf = h2c.hash_to_g2_plain(torch.from_numpy(h2c.msgs_to_u(msgs)))
    assert xy.shape == (4, 2, 2, 12) and inf.dtype == torch.int32
    assert inf.tolist() == [0] * 4
    assert [_xy_host(r) for r in xy.numpy()] == [
        _jaff(jhtc.hash_to_g2(m)) for m in msgs]


@pytest.fixture(scope="module")
def decompress_matrix():
    """Valid signatures with both sort flags, x off the curve, on-curve
    points outside G2 (both flags), and rows sigs_to_x rejected."""
    rng = random.Random(51)
    sigs = {"sign_0": _sig(52, 0), "sign_1": _sig(53, 1)}
    while True:
        x = JFp2(rng.randrange(P), rng.randrange(P))
        if (x * x * x + B_G2).sqrt() is None:
            break
    b = bytearray(x.to_bytes())
    b[0] |= 0x80
    sigs["off_curve"] = bytes(b)
    q = jhtc.map_to_curve_g2(JFp2(rng.randrange(P), rng.randrange(P)))
    sigs["outside_g2"] = q.to_bytes()
    sigs["outside_g2_neg"] = (-q).to_bytes()
    sigs["uncompressed"] = HEADER_CASES["uncompressed"]()
    sigs["infinity"] = HEADER_CASES["infinity"]()
    sigs["c1_eq_p"] = HEADER_CASES["c1_eq_p"]()
    names = sorted(sigs)
    xs, sign, valid = h2c.sigs_to_x([sigs[k] for k in names])
    xy, ok = h2c.decompress_plain(torch.from_numpy(xs),
                                  torch.from_numpy(sign.astype(np.int32)))
    return names, sigs, valid, xy.numpy(), ok.tolist()


def test_decompress_plain_matches_host(decompress_matrix):
    names, sigs, valid, xy, ok = decompress_matrix
    for i, name in enumerate(names):
        try:
            want = _jaff(jcurves.PointG2.from_bytes(sigs[name],
                                                    subgroup_check=True))
        except ValueError:
            want = None
        got = _xy_host(xy[i]) if ok[i] and valid[i] else None
        assert got == want, name
        if not ok[i]:
            assert not xy[i].any(), name     # rejected lanes write zeros
    accepted = {n for i, n in enumerate(names) if ok[i] and valid[i]}
    assert accepted == {"sign_0", "sign_1"}
    assert not ok[names.index("off_curve")]
    assert not ok[names.index("outside_g2")]
