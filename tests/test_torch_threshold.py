"""Slice 2 as a whole: the port's threshold round on the CPU (the plain
versions of its four kernels) against the JAX package's host code, on
small groups — the host-side packing functions of the JAX engine called
directly on the same inputs (``_select_shares``, ``_pack_msm_gls4``
through ops/convert.py, ``_unpack_eval_host``), then ``recover`` at both
packings, ``aggregate_round`` (all valid, a bad chosen partial, a
malformed partial, too few partials), ``eval_commits``,
``eval_poly_indices`` and ``verify_partials`` against the host oracle,
byte for byte. A known-answer gate that fails raises. No JAX graph is
built."""

import numpy as np
import pytest
import torch

from drand_tpu.crypto import tbls as jtbls
from drand_tpu.crypto.curves import PointG1 as JG1
from drand_tpu.crypto.poly import PriPoly as JPriPoly
from drand_tpu.crypto.poly import lagrange_coefficients as jlagrange
from drand_tpu.ops.engine import BatchedEngine as JEngine
from drand_tpu_torch import metrics
from drand_tpu_torch.crypto.curves import PointG1
from drand_tpu_torch.crypto.fields import P, Fp
from drand_tpu_torch.crypto.poly import lagrange_coefficients
from drand_tpu_torch.ops import convert, eval as ev
from drand_tpu_torch.ops.engine import BatchedEngine
from drand_tpu_torch.ops.limb import fp_words

torch.set_num_threads(1)

MSG = b"torch-threshold-round"
BUCKETS = (4, 32)     # pairing rounds of <= 3 partials; Horner lanes 32


@pytest.fixture(scope="module")
def group():
    """A 2-of-3 group: the JAX polynomial and its partials on MSG."""
    poly = JPriPoly.random(2, seed=b"torch-threshold-group")
    parts = [jtbls.sign_partial(s, MSG) for s in poly.shares(3)]
    return poly, parts


def _pub(poly):
    """A fresh port PubPoly (empty share-key cache) of a JAX polynomial."""
    return convert.pub_poly_from_jax(poly.commit())


@pytest.fixture(scope="module")
def eng():
    return BatchedEngine(device="cpu", buckets=BUCKETS)


def _flip(partial: bytes) -> bytes:
    """The JAX test's corruption: one bit of the signature's x."""
    return partial[:5] + bytes([partial[5] ^ 1]) + partial[6:]


def _host_key(poly, i) -> bytes:
    return poly.commit().eval(i).value.to_bytes()


# ---------------------------------------------------------------------------
# host-side functions of the JAX engine, called directly
# ---------------------------------------------------------------------------

def test_select_shares_matches_jax(group):
    poly, parts = group
    other = jtbls.sign_partial(poly.eval(7), MSG)        # index >= n
    mixed = [parts[1], parts[1], parts[0][:40], other, _flip(parts[2]),
             b"\x00\x02" + b"\xff" * 96, parts[2], parts[0]]
    want = JEngine._select_shares(mixed, 2, 3)
    got = BatchedEngine._select_shares(mixed, 2, 3)
    assert [s.index for s in got] == [s.index for s in want] == [1, 2]
    assert [s.value.to_bytes() for s in got] == \
        [s.value.to_bytes() for s in want]


@pytest.mark.parametrize("b", [8, 16])
def test_pack_msm_gls4_matches_jax(group, b):
    _, parts = group
    jshares = JEngine._select_shares(parts, 2, 3)
    shares = BatchedEngine._select_shares(parts, 2, 3)
    jl = jlagrange([s.index for s in jshares])
    lam = lagrange_coefficients([s.index for s in shares])
    assert jl == lam
    want = convert.msm_inputs_from_jax(*JEngine._pack_msm_gls4(jshares, jl, b))
    pts, inf, bits = BatchedEngine._pack_msm_gls4(shares, lam, b)
    got = (torch.from_numpy(pts), torch.from_numpy(inf.astype(np.int32)),
           torch.from_numpy(bits))
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_unpack_eval_host_matches_jax():
    """Jacobian rows with Z != 1, an infinity-flagged row and a Z = 0
    row, through both packages' unpacking."""
    g = PointG1.generator()
    rows, expect = [], []
    for k, z in ((3, 5), (11, 1), (0x1234, P - 2)):
        x, y = g.mul(k).to_affine()
        rows.append([x.v * z * z % P, y.v * z * z * z % P, z, 0])
        expect.append(g.mul(k))
    rows.append([1, 1, 0, 1])
    rows.append([7, 9, 0, 0])
    expect += [PointG1.infinity()] * 2
    xyz = np.stack([np.stack([fp_words(v) for v in r[:3]]) for r in rows])
    inf = np.array([r[3] for r in rows], np.int32)
    got = BatchedEngine._unpack_eval_host(xyz, inf, len(rows))
    theirs = JEngine._unpack_eval_host(
        convert.eval_rows_to_jax(torch.from_numpy(xyz), inf), 3, len(rows))
    assert got == expect
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in theirs]
    assert got[0].Z == Fp(1)


# ---------------------------------------------------------------------------
# the engine on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gls4", [True, False], ids=["gls4", "full_255bit"])
def test_recover_matches_host(group, eng, gls4):
    poly, parts = group
    e = eng if gls4 else BatchedEngine(device="cpu", buckets=BUCKETS,
                                       gls4=False)
    want = jtbls.recover(poly.commit(), MSG, parts, 2, 3)
    assert e.recover(_pub(poly), MSG, parts, 2, 3) == want
    with pytest.raises(ValueError):
        e.recover(_pub(poly), MSG, parts[:1], 2, 3)


def test_aggregate_round_all_valid(group, eng):
    poly, parts = group
    pub = _pub(poly)
    eng.check_round(3, 2)          # gates first: the meters count the round
    checks, pairs = metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS
    oks, sig = eng.aggregate_round(pub, MSG, parts, 2, 3)
    assert oks == [True, True, True]
    assert sig == jtbls.recover(poly.commit(), MSG, parts, 2, 3)
    assert metrics.N_PRODUCT_CHECKS - checks == 1
    assert metrics.N_MILLER_PAIRS - pairs == 2 * 4
    assert eng.agg_fused_active(3, 2)
    # the round's Horner filled the share-key cache with the host's keys
    assert {i: s.value.to_bytes() for i, s in pub._eval_cache.items()} == \
        {i: _host_key(poly, i) for i in range(3)}


def test_aggregate_round_bad_chosen_partial(group, eng):
    """The JAX engine's test case: a corrupt partial first in line is
    flagged, and recovery uses the valid survivors."""
    poly, parts = group
    oks, sig = eng.aggregate_round(_pub(poly), MSG,
                                   [_flip(parts[0]), parts[1], parts[2]], 2, 3)
    assert oks == [False, True, True]
    assert sig == jtbls.recover(poly.commit(), MSG, parts[1:], 2, 3)


def test_aggregate_round_malformed_partial(group, eng):
    poly, parts = group
    oks, sig = eng.aggregate_round(_pub(poly), MSG,
                                   [parts[0], parts[1][:60], parts[2]], 2, 3)
    assert oks == [True, False, True]
    assert sig == jtbls.recover(poly.commit(), MSG, [parts[0], parts[2]], 2, 3)


def test_aggregate_round_not_enough(group, eng):
    poly, parts = group
    with pytest.raises(ValueError):
        eng.aggregate_round(_pub(poly), MSG, [parts[0], parts[1][:60]], 2, 3)


def test_verify_partials_on_device_share_keys(group, eng):
    poly, parts = group
    other = jtbls.sign_partial(poly.eval(1), b"another round")
    batch = [parts[0], other, parts[2][:50]]
    want = [jtbls.verify_partial(poly.commit(), MSG, p) for p in batch]
    assert want == [True, False, False]
    pub = _pub(poly)
    assert eng.verify_partials(pub, MSG, batch) == want
    assert sorted(pub._eval_cache) == [0, 1]


def test_eval_poly_indices_matches_host(group, eng):
    poly, _ = group
    idx = [0, 2, 1022, 5]
    got = eng.eval_poly_indices(_pub(poly), idx)
    assert [p.to_bytes() for p in got] == [_host_key(poly, i) for i in idx]
    with pytest.raises(ValueError):
        eng.eval_poly_indices(_pub(poly), [2047])


def test_eval_commits_matches_host(eng):
    """Three dealers' 3-coefficient polynomials at one index; a dealer
    with an infinite commitment is evaluated by the host."""
    polys = [JPriPoly.random(3, seed=b"torch-dealer-%d" % d).commit()
             for d in range(3)]
    polys.append(type(polys[0])([JG1.infinity()] + polys[0].commits[1:]))
    got = eng.eval_commits([convert.pub_poly_from_jax(p) for p in polys], 4)
    assert [p.to_bytes() for p in got] == \
        [p.eval(4).value.to_bytes() for p in polys]


def test_failed_gate_raises_without_fallback(group, monkeypatch):
    """A Horner that computes a wrong key fails its known-answer gate,
    and the engine raises — also inside ``verify_partials``, where the
    JAX engine would fall back to the host."""
    poly, parts = group
    good = ev.horner_plain

    def wrong(commits, bits, affine=False):
        xyz, inf = good(commits, bits, affine)
        return xyz.flip(0), inf

    monkeypatch.setattr(ev, "horner_plain", wrong)
    e = BatchedEngine(device="cpu", buckets=BUCKETS)
    with pytest.raises(RuntimeError, match="known-answer"):
        e.eval_poly_indices(_pub(poly), [0, 1])
    with pytest.raises(RuntimeError, match="known-answer"):
        e.verify_partials(_pub(poly), MSG, parts)
