"""The port's own host BLS12-381 code (drand_tpu_torch/crypto/*.py and
chain/beacon.py — copies kept so the port imports nothing of the JAX
package) held against the JAX package's host modules on the same
seeded inputs: fields, curves and point encodings, hash-to-curve,
pairings, BLS, polynomials, threshold BLS and the beacon messages.

Every comparison is exact: field elements by their integer
coefficients, points by their compressed encodings, signatures and
messages byte for byte. Each case is a few host operations (no
tensor work), so the file stays cheap."""

import random

import pytest

from drand_tpu.chain import beacon as jbeacon
from drand_tpu.crypto import (bls as jbls, curves as jc, fields as jf,
                              hash_to_curve as jh, pairing as jp,
                              poly as jpoly, tbls as jtbls)
from drand_tpu_torch.chain import beacon as pbeacon
from drand_tpu_torch.crypto import (bls as pbls, curves as pc, fields as pf,
                                    hash_to_curve as ph, pairing as pp,
                                    poly as ppoly, tbls as ptbls)

P, R = jf.P, jf.R


def _ints(x) -> list[int]:
    """Integer coefficients of an Fp/Fp2/Fp6/Fp12 value (or an int)."""
    if isinstance(x, int):
        return [x]
    if hasattr(x, "c2"):
        return _ints(x.c0) + _ints(x.c1) + _ints(x.c2)
    if hasattr(x, "c1"):
        return _ints(x.c0) + _ints(x.c1)
    return [x.v]


def _build(mod, level: str, ints: list[int]):
    """A value of ``mod``'s tower at ``level`` from integer coefficients."""
    if level == "fp2":
        return mod.Fp2(*ints)
    if level == "fp6":
        return mod.Fp6(*[mod.Fp2(*ints[i:i + 2]) for i in range(0, 6, 2)])
    return mod.Fp12(_build(mod, "fp6", ints[:6]), _build(mod, "fp6", ints[6:]))


_WIDTH = {"fp2": 2, "fp6": 6, "fp12": 12}


def _pair(level: str, seed: int):
    """The same random element of ``level`` in the port and the reference."""
    rng = random.Random(f"{level}-{seed}")
    ints = [rng.randrange(P) for _ in range(_WIDTH[level])]
    return _build(pf, level, ints), _build(jf, level, ints)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

_FP_FUNCS = {
    "fp_add": lambda m, a, b: m.fp_add(a, b),
    "fp_sub": lambda m, a, b: m.fp_sub(a, b),
    "fp_mul": lambda m, a, b: m.fp_mul(a, b),
    "fp_neg": lambda m, a, b: m.fp_neg(a),
    "fp_inv": lambda m, a, b: m.fp_inv(a),
    "fp_is_square": lambda m, a, b: m.fp_is_square(a),
    "fp_sqrt": lambda m, a, b: m.fp_sqrt(m.fp_mul(a, a)),
    "fp_bytes": lambda m, a, b: m.fp_from_bytes(m.fp_to_bytes(a)),
    "fr_mul": lambda m, a, b: m.fr_mul(a % R, b % R),
    "fr_inv": lambda m, a, b: m.fr_inv(a % R or 1),
    "fr_from_seed": lambda m, a, b: m.fr_from_seed(b"dom", a.to_bytes(48, "big")),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", sorted(_FP_FUNCS))
def test_fp_functions_match_reference(fn, seed):
    rng = random.Random(f"{fn}-{seed}")
    cases = [(rng.randrange(1, P), rng.randrange(P)) for _ in range(4)]
    cases += [(1, P - 1), (P - 1, 2)]
    f = _FP_FUNCS[fn]
    assert [f(pf, a, b) for a, b in cases] == [f(jf, a, b) for a, b in cases]


_TOWER_OPS = {
    "fp2": {
        "mul": lambda x, y: x * y, "square": lambda x, y: x.square(),
        "inverse": lambda x, y: x.inverse(), "add": lambda x, y: x + y,
        "sub": lambda x, y: x - y, "conjugate": lambda x, y: x.conjugate(),
        "sqrt": lambda x, y: (x * x).sqrt(), "frobenius": lambda x, y: x.frobenius(),
        "to_bytes": lambda x, y: x.to_bytes(),
    },
    "fp6": {
        "mul": lambda x, y: x * y, "square": lambda x, y: x.square(),
        "inverse": lambda x, y: x.inverse(), "mul_by_v": lambda x, y: x.mul_by_v(),
        "sub": lambda x, y: x - y,
    },
    "fp12": {
        "mul": lambda x, y: x * y, "square": lambda x, y: x.square(),
        "inverse": lambda x, y: x.inverse(), "conjugate": lambda x, y: x.conjugate(),
        "frobenius_1": lambda x, y: x.frobenius(1),
        "frobenius_2": lambda x, y: x.frobenius(2),
        "frobenius_3": lambda x, y: x.frobenius(3),
        "pow": lambda x, y: x.pow(0xD201000000010000),
    },
}


@pytest.mark.parametrize("level,op", [(lv, op) for lv in sorted(_TOWER_OPS)
                                      for op in sorted(_TOWER_OPS[lv])])
def test_tower_ops_match_reference(level, op):
    (px, jx), (py, jy) = _pair(level, 1), _pair(level, 2)
    f = _TOWER_OPS[level][op]
    got, want = f(px, py), f(jx, jy)
    if isinstance(want, bytes):
        assert got == want
    else:
        assert _ints(got) == _ints(want)


def test_cyclotomic_square_and_pow_match_reference():
    px, jx = _pair("fp12", 3)
    # the easy part of the final exponentiation lands in the cyclotomic
    # subgroup, where these two are defined
    pc_, jc_ = (px.conjugate() * px.inverse(), jx.conjugate() * jx.inverse())
    pc_, jc_ = pc_.frobenius(2) * pc_, jc_.frobenius(2) * jc_
    assert _ints(pc_.cyclotomic_square()) == _ints(jc_.cyclotomic_square())
    assert _ints(pc_.cyclotomic_pow(0xD201)) == _ints(jc_.cyclotomic_pow(0xD201))


def test_frobenius_constants_match_reference():
    for k in pf._FROBENIUS_GAMMA:
        assert ([_ints(g) for g in pf._FROBENIUS_GAMMA[k]]
                == [_ints(g) for g in jf._FROBENIUS_GAMMA[k]])


# ---------------------------------------------------------------------------
# curves and encodings
# ---------------------------------------------------------------------------

_SCALARS = [1, 2, R - 1, 0x1D2C3B, (1 << 255) + 12345]


@pytest.mark.parametrize("k", _SCALARS, ids=lambda k: f"k{k.bit_length()}_{k & 0xFF}")
@pytest.mark.parametrize("group", ["PointG1", "PointG2"])
def test_scalar_mul_encodings_match_reference(group, k):
    got = getattr(pc, group).generator().mul(k)
    want = getattr(jc, group).generator().mul(k)
    assert got.to_bytes() == want.to_bytes()
    back = getattr(pc, group).from_bytes(want.to_bytes())
    assert back == got and back.to_bytes() == want.to_bytes()


_POINT_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "double": lambda a, b: a.double(),
    "neg": lambda a, b: -a,
    "add_self": lambda a, b: a + a,
    "add_neg": lambda a, b: a + (-a),
    "clear_cofactor": lambda a, b: a.clear_cofactor(),
}


@pytest.mark.parametrize("op", sorted(_POINT_OPS))
@pytest.mark.parametrize("group", ["PointG1", "PointG2"])
def test_point_ops_match_reference(group, op):
    pa, pb_ = (getattr(pc, group).generator().mul(k) for k in (77, 1234567))
    ja, jb = (getattr(jc, group).generator().mul(k) for k in (77, 1234567))
    f = _POINT_OPS[op]
    assert f(pa, pb_).to_bytes() == f(ja, jb).to_bytes()


@pytest.mark.parametrize("group", ["PointG1", "PointG2"])
def test_msm_and_point_hash_match_reference(group):
    pts_p = [getattr(pc, group).generator().mul(k) for k in (3, 5, 7)]
    pts_j = [getattr(jc, group).generator().mul(k) for k in (3, 5, 7)]
    scal = [11, R - 2, 1 << 200]
    got = getattr(pc, group).msm(scal, pts_p)
    assert got.to_bytes() == getattr(jc, group).msm(scal, pts_j).to_bytes()
    assert [p.hash() for p in pts_p] == [p.hash() for p in pts_j]
    assert all(p.in_subgroup() and p.is_on_curve() for p in pts_p)


def test_g1_comb_mul_matches_reference():
    for k in (1, 0xABCDEF, R - 1):
        assert pc.g1_comb_mul(k).to_bytes() == jc.g1_comb_mul(k).to_bytes()


def _bad_encodings():
    g1 = jc.PointG1.generator().to_bytes()
    g2 = jc.PointG2.generator().to_bytes()
    return {
        "g1_short": ("PointG1", g1[:-1]),
        "g1_uncompressed_flag": ("PointG1", bytes([g1[0] & 0x7F]) + g1[1:]),
        "g1_x_not_on_curve": ("PointG1", bytes([g1[0]]) + g1[1:-1] + b"\x00"),
        "g1_x_above_p": ("PointG1", b"\x9f" + b"\xff" * 47),
        "g1_infinity": ("PointG1", b"\xc0" + b"\x00" * 47),
        "g2_short": ("PointG2", g2[:-1]),
        "g2_x_not_on_curve": ("PointG2", bytes([g2[0]]) + g2[1:-1] + b"\x01"),
        "g2_infinity": ("PointG2", b"\xc0" + b"\x00" * 95),
        "g2_bad_infinity": ("PointG2", b"\xc0" + b"\x00" * 94 + b"\x01"),
    }


def _decode(mod, group, data):
    try:
        return getattr(mod, group).from_bytes(data).to_bytes()
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("case", sorted(_bad_encodings()))
def test_decoding_edge_cases_match_reference(case):
    """Malformed or special encodings: the port accepts exactly what the
    reference accepts, and rejects the rest with ValueError."""
    group, data = _bad_encodings()[case]
    assert _decode(pc, group, data) == _decode(jc, group, data)


# ---------------------------------------------------------------------------
# hash to curve
# ---------------------------------------------------------------------------

_MSGS = [b"", b"abc", b"abcdef0123456789", b"q128_" + b"q" * 128,
         b"a512_" + b"a" * 512]


@pytest.mark.parametrize("n", [32, 128, 256])
def test_expand_message_xmd_matches_reference(n):
    dst = b"QUUX-V01-CS02-with-expander-SHA256-128"
    assert ([ph.expand_message_xmd(m, dst, n) for m in _MSGS]
            == [jh.expand_message_xmd(m, dst, n) for m in _MSGS])


@pytest.mark.parametrize("msg", _MSGS, ids=lambda m: f"len{len(m)}")
def test_hash_to_g2_matches_reference(msg):
    got = ph.hash_to_g2(msg)
    assert got.to_bytes() == jh.hash_to_g2(msg).to_bytes()
    assert got.in_subgroup()


def test_hash_to_field_and_map_match_reference():
    dst = ph.DEFAULT_DST_G2
    us_p = ph.hash_to_field_fp2(b"map", dst, 2)
    us_j = jh.hash_to_field_fp2(b"map", dst, 2)
    assert [_ints(u) for u in us_p] == [_ints(u) for u in us_j]
    for up, uj in zip(us_p, us_j):
        assert ([_ints(c) for c in ph.map_to_curve_sswu(up)]
                == [_ints(c) for c in jh.map_to_curve_sswu(uj)])
        assert (ph.map_to_curve_g2(up).to_bytes()
                == jh.map_to_curve_g2(uj).to_bytes())


def test_hash_to_g2_cache_counts():
    """The memo's counters live for the process; clearing empties it."""
    ph.h2c_cache_clear()
    before = ph.h2c_cache_info()
    first = ph.hash_to_g2(b"cache-probe")
    assert ph.hash_to_g2(b"cache-probe") is first
    info = ph.h2c_cache_info()
    assert (info["hits"] - before["hits"], info["misses"] - before["misses"],
            info["size"]) == (1, 1, 1)


# ---------------------------------------------------------------------------
# pairings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a,b", [(1, 1), (5, 9)])
def test_pairing_value_matches_reference(a, b):
    got = pp.pairing(pc.PointG1.generator().mul(a), pc.PointG2.generator().mul(b))
    want = jp.pairing(jc.PointG1.generator().mul(a), jc.PointG2.generator().mul(b))
    assert _ints(got) == _ints(want)


@pytest.mark.parametrize("valid", [True, False])
def test_pairing_checks_match_reference(valid):
    def pairs(m):
        k = 6 if valid else 7
        return [(-m.PointG1.generator().mul(2), m.PointG2.generator().mul(3)),
                (m.PointG1.generator(), m.PointG2.generator().mul(k))]
    assert pp.pairing_check(pairs(pc)) is valid
    assert jp.pairing_check(pairs(jc)) is valid
    groups_p, groups_j = [pairs(pc)] * 2, [pairs(jc)] * 2
    assert (pp.pairing_check_groups(groups_p)
            == jp.pairing_check_groups(groups_j))
    assert ([_ints(f) for f in pp.miller_loop_groups(groups_p[:1])]
            == [_ints(f) for f in jp.miller_loop_groups(groups_j[:1])])


# ---------------------------------------------------------------------------
# BLS, polynomials, threshold BLS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [b"alpha", b"beta"])
def test_bls_keygen_and_sign_match_reference(seed):
    sk, pub = pbls.keygen(seed)
    jsk, jpub = jbls.keygen(seed)
    assert sk == jsk and pub.to_bytes() == jpub.to_bytes()
    assert pbls.sign(sk, b"m:" + seed) == jbls.sign(jsk, b"m:" + seed)


@pytest.mark.parametrize("case", ["valid", "wrong_msg", "undecodable",
                                  "truncated"])
def test_bls_verify_matches_reference(case):
    sk, pub = pbls.keygen(b"verify")
    sig = pbls.sign(sk, b"msg")
    msg = b"other" if case == "wrong_msg" else b"msg"
    if case == "undecodable":
        sig = b"\xff" * 96
    elif case == "truncated":
        sig = sig[:-1]
    got = pbls.verify(pub, msg, sig)
    assert got == jbls.verify(jc.PointG1.from_bytes(pub.to_bytes()), msg, sig)
    assert got is (case == "valid")


@pytest.fixture(scope="module")
def polys():
    return (ppoly.PriPoly.random(4, seed=b"port-poly"),
            jpoly.PriPoly.random(4, seed=b"port-poly"))


def test_pripoly_and_shares_match_reference(polys):
    p, j = polys
    assert p.coeffs == j.coeffs and p.secret() == j.secret()
    assert ([(s.index, s.value) for s in p.shares(7)]
            == [(s.index, s.value) for s in j.shares(7)])
    assert ([(s.index, s.value) for s in p.eval_many([0, 3, 9])]
            == [(s.index, s.value) for s in j.eval_many([0, 3, 9])])
    assert p.eval(2).hash() == j.eval(2).hash()
    both = p.add(p)
    assert both.coeffs == j.add(j).coeffs


def test_pubpoly_matches_reference(polys):
    p, j = polys
    pp_, jp_ = p.commit(), j.commit()
    assert [c.to_bytes() for c in pp_.commits] == [c.to_bytes() for c in jp_.commits]
    assert pp_.commit().to_bytes() == jp_.commit().to_bytes()
    assert ([s.value.to_bytes() for s in pp_.eval_many([1, 4])]
            == [s.value.to_bytes() for s in jp_.eval_many([1, 4])])
    assert pp_.add(pp_).commit().to_bytes() == jp_.add(jp_).commit().to_bytes()
    assert pp_ == p.commit()


@pytest.mark.parametrize("idx", [[0, 1, 2, 3], [1, 3, 5, 6], [6, 2, 4, 0]],
                         ids=["first", "spread", "unordered"])
def test_recovery_matches_reference(polys, idx):
    p, j = polys
    assert ppoly.lagrange_coefficients(idx) == jpoly.lagrange_coefficients(idx)
    shares_p = [p.eval(i) for i in idx]
    assert ppoly.recover_secret(shares_p, 4) == p.secret()
    assert (ppoly.recover_secret(shares_p, 4)
            == jpoly.recover_secret([j.eval(i) for i in idx], 4))
    pub_p = p.commit()
    got = ppoly.recover_commit([pub_p.eval(i) for i in idx], 4)
    assert got.to_bytes() == pub_p.commit().to_bytes()


@pytest.mark.parametrize("n", [1, 3, 10, 21, 256])
def test_minimum_threshold_matches_reference(n):
    assert ppoly.minimum_threshold(n) == jpoly.minimum_threshold(n)


def test_tbls_partials_and_recovery_match_reference(polys):
    p, j = polys
    msg = jbeacon.message_v2(42)
    partials_p = [ptbls.sign_partial(s, msg) for s in p.shares(6)]
    partials_j = [jtbls.sign_partial(s, msg) for s in j.shares(6)]
    assert partials_p == partials_j
    assert [ptbls.index_of(x) for x in partials_p] == list(range(6))
    # a duplicate and a malformed partial are skipped, as in the reference
    mixed = [partials_p[5], partials_p[5], b"\x00\x01", *partials_p[1:4]]
    got = ptbls.recover(p.commit(), msg, mixed, 4, 6)
    assert got == jtbls.recover(j.commit(), msg, mixed, 4, 6)
    assert got == pbls.sign(p.secret(), msg)
    with pytest.raises(ValueError):
        ptbls.recover(p.commit(), msg, partials_p[:3], 4, 6)


@pytest.mark.parametrize("case", ["valid", "wrong_share", "short"])
def test_tbls_verify_partial_matches_reference(polys, case):
    p, j = polys
    msg = b"partial"
    part = ptbls.sign_partial(p.eval(2), msg)
    if case == "wrong_share":
        part = (2).to_bytes(2, "big") + ptbls.sign_partial(p.eval(3), msg)[2:]
    elif case == "short":
        part = part[:-1]
    got = ptbls.verify_partial(p.commit(), msg, part)
    assert got == jtbls.verify_partial(j.commit(), msg, part)
    assert got is (case == "valid")


# ---------------------------------------------------------------------------
# beacon messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rnd", [0, 1, 2, 1 << 32, (1 << 64) - 1])
def test_beacon_messages_match_reference(rnd):
    prev = bytes(range(96))
    assert pbeacon.round_to_bytes(rnd) == jbeacon.round_to_bytes(rnd)
    assert pbeacon.message(rnd, prev) == jbeacon.message(rnd, prev)
    assert pbeacon.message_v2(rnd) == jbeacon.message_v2(rnd)
    assert (pbeacon.randomness_from_signature(prev)
            == jbeacon.randomness_from_signature(prev))


def test_beacon_codec_and_verification_match_reference(polys):
    p, j = polys
    secret, key = p.secret(), p.commit().commit()
    prev = b"genesis-seed"
    b = pbeacon.Beacon(round=3, previous_sig=prev,
                       signature=pbls.sign(secret, pbeacon.message(3, prev)),
                       signature_v2=pbls.sign(secret, pbeacon.message_v2(3)))
    jb = jbeacon.Beacon.unmarshal(b.marshal())
    assert jb.marshal() == b.marshal()
    assert pbeacon.Beacon.unmarshal(jb.marshal()).equal(b)
    assert b.randomness() == jb.randomness() and b.is_v2() and jb.is_v2()
    jkey = j.commit().commit()
    assert pbeacon.verify_beacon(key, b) and jbeacon.verify_beacon(jkey, jb)
    assert pbeacon.verify_beacon_v2(key, b) and jbeacon.verify_beacon_v2(jkey, jb)
    b.round = jb.round = 4
    assert not pbeacon.verify_beacon(key, b)
    assert not jbeacon.verify_beacon(jkey, jb)
