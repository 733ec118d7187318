"""The port's ψ endomorphism (crypto/endo.py) and plain point arithmetic
(ops/curve.py), held exactly against the JAX package's host code on the
same seeded inputs: the ψ and GLS4 constants and maps, the accept set of
the fast subgroup check and of signature decoding, and the complete
Jacobian addition over Fp and Fp2 in all of its cases against
``drand_tpu.crypto.curves``. No JAX graph is built."""

import random

import numpy as np
import pytest
import torch

from drand_tpu.crypto import batch_verify as jbv
from drand_tpu.crypto import curves as jcurves
from drand_tpu.crypto import endo as jendo
from drand_tpu.crypto import hash_to_curve as jh2c
from drand_tpu.ops import curve as jcurve
from drand_tpu_torch.crypto import endo
from drand_tpu_torch.crypto import hash_to_curve as h2c
from drand_tpu_torch.crypto.curves import PointG1, PointG2
from drand_tpu_torch.crypto.fields import R, Fp, Fp2
from drand_tpu_torch.ops import curve as cv
from drand_tpu_torch.ops.engine import decode_sig
from drand_tpu_torch.ops.limb import (fp_from_words, fp_words,
                                      halves_to_words, words_to_halves)

torch.set_num_threads(1)

M = endo.GLS4_M


def _f2(a) -> tuple[int, int]:
    return a.c0, a.c1


def _g2_bytes(pt) -> bytes:
    return pt.to_bytes()


def _jg2(pt: PointG2):
    """The same point as a JAX-package host point."""
    return jcurves.PointG2.from_bytes(pt.to_bytes(), subgroup_check=False)


def _rand_g2(seed: int) -> PointG2:
    return PointG2.generator().mul(random.Random(seed).randrange(1, R))


# ---------------------------------------------------------------------------
# crypto/endo.py
# ---------------------------------------------------------------------------

def test_psi_and_gls4_constants_match_jax():
    for name in ("PSI_CX", "PSI_CY", "PSI2_CX", "PSI2_CY", "PSI3_CX",
                 "PSI3_CY"):
        assert _f2(getattr(endo, name)) == _f2(getattr(jendo, name)), name
    assert endo.GLS4_M == jendo.GLS4_M
    assert endo.GLS4_DIGIT_BITS == jendo.GLS4_DIGIT_BITS == 64


@pytest.mark.parametrize("c", [0, 1, R - 1, M - 1, M, M ** 2, M ** 3,
                               M ** 3 - 1, R, R + 5,
                               random.Random(11).randrange(R)],
                         ids=["0", "1", "r-1", "M-1", "M", "M^2", "M^3",
                              "M^3-1", "r", "r+5", "random"])
def test_gls4_decompose_matches_jax(c):
    got = endo.gls4_decompose(c)
    assert got == jendo.gls4_decompose(c)
    assert all(0 <= d < 1 << 64 for d in got)
    assert sum(d * M ** k for k, d in enumerate(got)) == c % R


def test_gls4_points_from_affine_matches_jax():
    pt = _rand_g2(5)
    x, y = pt.to_affine()
    jx, jy = _jg2(pt).to_affine()
    got = endo.gls4_points_from_affine(x, y)
    want = jendo.gls4_points_from_affine(jx, jy)
    for a, b in zip(got, want):
        assert (_f2(a.X), _f2(a.Y), _f2(a.Z)) == (_f2(b.X), _f2(b.Y), _f2(b.Z))
    # the basis is [M^k]P
    for k, b in enumerate(got):
        assert b == pt.mul(M ** k % R)


@pytest.mark.parametrize("seed", [1, 2])
def test_psi_maps_match_jax(seed):
    pt = _rand_g2(seed)
    jpt = _jg2(pt)
    for ours, theirs in ((endo.psi, jendo.psi), (endo.psi2, jendo.psi2),
                         (endo.psi3, jendo.psi3)):
        assert _g2_bytes(ours(pt)) == theirs(jpt).to_bytes()
    assert endo.psi(PointG2.infinity()).is_infinity()


def _twist_point(seed: int) -> PointG2:
    """A point on the twist outside the r-order subgroup (SSWU + isogeny
    output before cofactor clearing)."""
    (u,) = h2c.hash_to_field_fp2(b"torch-curve-%d" % seed,
                                 h2c.DEFAULT_DST_G2, 1)
    return h2c.map_to_curve_g2(u)


@pytest.mark.parametrize("case", ["subgroup", "twist", "infinity"])
def test_subgroup_check_fast_accept_set(case):
    if case == "subgroup":
        pt = _rand_g2(3)
    elif case == "twist":
        pt = _twist_point(1)
        (ju,) = jh2c.hash_to_field_fp2(b"torch-curve-1", jh2c.DEFAULT_DST_G2, 1)
        assert jh2c.map_to_curve_g2(ju).to_bytes() == pt.to_bytes()
    else:
        pt = PointG2.infinity()
    got = endo.subgroup_check_fast(pt)
    assert got == (case != "twist")
    assert got == pt.in_subgroup()
    assert got == jendo.subgroup_check_fast(_jg2(pt))


@pytest.mark.parametrize("case", ["valid", "twist", "infinity", "malformed",
                                  "short"])
def test_decode_sig_accept_set_matches_jax(case):
    data = {"valid": lambda: _rand_g2(4).to_bytes(),
            "twist": lambda: _twist_point(2).to_bytes(),
            "infinity": lambda: PointG2.infinity().to_bytes(),
            "malformed": lambda: b"\xff" * 96,
            "short": lambda: _rand_g2(4).to_bytes()[:95]}[case]()
    got, want = decode_sig(data), jbv.decode_sig(data)
    assert (got is None) == (want is None) == (case != "valid")
    if got is not None:
        assert got.to_bytes() == want.to_bytes() == data


# ---------------------------------------------------------------------------
# ops/curve.py: plain Jacobian arithmetic against the host curves
# ---------------------------------------------------------------------------

_GROUPS = {"g1": (cv.F1, PointG1, jcurves.PointG1),
           "g2": (cv.F2, PointG2, jcurves.PointG2)}


def _words(v) -> np.ndarray:
    if isinstance(v, Fp2):
        return np.stack([fp_words(v.c0), fp_words(v.c1)])
    return fp_words(v.v)


def _from_words(F, w):
    if F is cv.F2:
        return Fp2(fp_from_words(w[0]), fp_from_words(w[1]))
    return Fp(fp_from_words(w))


def _plain(F, pt, z: int):
    """A host point as a one-lane plain point, in Jacobian form with
    Z = z (the same point), or the JAX convention (1, 1, 0) at infinity."""
    if pt.is_infinity():
        coords = [F.one((), "cpu"), F.one((), "cpu"), F.zero((), "cpu")]
        return tuple(c[None] for c in coords) + (torch.ones(1, dtype=torch.bool),)
    x, y = pt.to_affine()
    zf = type(x)(z) if F is cv.F1 else Fp2(z, z + 1)
    X, Y, Z = x * zf.square(), y * zf.square() * zf, zf
    h = words_to_halves(torch.from_numpy(np.stack([_words(X), _words(Y),
                                                   _words(Z)]))[:, None])
    return h[0], h[1], h[2], torch.zeros(1, dtype=torch.bool)


def _host(F, G, p):
    """A one-lane plain point back to a host point."""
    if bool(p[3][0]):
        return G.infinity()
    w = [halves_to_words(c)[0].numpy() for c in p[:3]]
    return G(*(_from_words(F, x) for x in w))


_CASES = {
    # (P, Q) as multiples of the generator; None is infinity
    "generic": (3, 5),
    "doubling": (7, 7),          # H = 0, S = 0
    "inverse": (7, -7),          # H = 0, S != 0
    "left_infinity": (None, 9),
    "right_infinity": (9, None),
    "both_infinity": (None, None),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_pt_add_complete_matches_host(group, case):
    F, G, JG = _GROUPS[group]
    a, b = _CASES[case]

    def pt(k):
        return G.infinity() if k is None else G.generator().mul(k)

    def jpt(k):
        return JG.infinity() if k is None else JG.generator().mul(k)

    p1, p2 = _plain(F, pt(a), 3), _plain(F, pt(b), 5)
    got = _host(F, G, cv.pt_add(F, p1, p2))
    want = jpt(a) + jpt(b)
    assert got.to_bytes() == want.to_bytes()
    assert bool(cv.pt_add(F, p1, p2)[3][0]) == want.is_infinity()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_pt_dbl_and_to_affine_match_host(group):
    F, G, JG = _GROUPS[group]
    p = _plain(F, G.generator().mul(11), 7)
    assert _host(F, G, cv.pt_dbl(F, p)).to_bytes() == \
        JG.generator().mul(22).to_bytes()
    x, y, inf = cv.pt_to_affine(F, p)
    hx, hy = G.generator().mul(11).to_affine()
    assert not bool(inf[0])
    assert _from_words(F, halves_to_words(x)[0].numpy()) == hx
    assert _from_words(F, halves_to_words(y)[0].numpy()) == hy


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_pt_mul_bits_per_lane_matches_host(group):
    F, G, _ = _GROUPS[group]
    ks = [0, 1, 6, 1023]
    base = G.generator().mul(13)
    lanes = [_plain(F, base, 2 + j) for j in range(len(ks))]
    p = tuple(torch.cat([lane[i] for lane in lanes]) for i in range(4))
    bits = torch.from_numpy(np.stack([cv.scalar_to_bits(k, 10) for k in ks]))
    acc = cv.pt_mul_bits(F, p, bits)
    for j, k in enumerate(ks):
        lane = tuple(c[j:j + 1] for c in acc)
        assert _host(F, G, lane) == base.mul(k)


@pytest.mark.parametrize("k,nbits", [(0, 11), (1, 11), (2046, 11),
                                     (1 << 63, 64), (R - 1, 255)])
def test_scalar_to_bits_matches_jax(k, nbits):
    assert np.array_equal(cv.scalar_to_bits(k, nbits),
                          jcurve.scalar_to_bits(k, nbits))
    with pytest.raises(ValueError):
        cv.scalar_to_bits(1 << nbits, nbits)
