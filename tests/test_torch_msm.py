"""The plain versions of the port's two curve kernels — the G2 MSM
(ops/msm.py, kernel 7) and the G1 Horner (ops/eval.py, kernel 13) —
held exactly to the host oracle on the inputs that the JAX package's own
tests use for its references of those kernels
(tests/test_eval_commits.py::test_msm_fold_bl_matches_host and
::test_horner_bl_matches_host), fed from one numpy source through
ops/convert.py. Also: 255-bit scalars, the all-masked MSM, 11-bit
Horner indices up to 1023 (the reference kernel's ladder stops at 10
bits), and the wrappers' input checks. Nothing is compiled; no JAX graph
is built."""

import random

import numpy as np
import pytest
import torch

from drand_tpu.crypto.curves import PointG1 as JG1, PointG2 as JG2
from drand_tpu.crypto.fields import R
from drand_tpu.crypto.poly import PubPoly as JPubPoly
from drand_tpu.ops import curve as jcurve
from drand_tpu.ops.engine import BatchedEngine as JEngine, _g1_xy, _g2_aff
from drand_tpu_torch.crypto.curves import PointG2
from drand_tpu_torch.ops import convert, engine, eval as ev, msm
from drand_tpu_torch.ops.limb import NWORDS

torch.set_num_threads(1)


def _msm_case(seed: int, b: int, nbits: int, n_live: int, scalar_top: int):
    """The JAX test's construction: n_live points and scalars from
    ``random.Random(seed)``, the other lanes zero and masked; packed with
    the JAX engine's ``_g2_aff`` and converted."""
    rnd = random.Random(seed)
    pts = [JG2.generator().mul(rnd.randrange(1, 1 << 40))
           for _ in range(n_live)]
    scalars = [rnd.randrange(1, scalar_top) for _ in pts]
    arr = np.zeros((b, 2, 2, 32), np.int32)
    inf = np.ones(b, bool)
    bits = np.zeros((b, nbits), np.int32)
    for i, (p, s) in enumerate(zip(pts, scalars)):
        arr[i] = _g2_aff(p)
        inf[i] = False
        bits[i] = jcurve.scalar_to_bits(s, nbits)
    expect = JG2.infinity()
    for p, s in zip(pts, scalars):
        expect = expect + p.mul(s)
    return convert.msm_inputs_from_jax(arr, inf, bits), expect


def _msm_point(xy, inf):
    assert inf.dtype == torch.int32 and inf.shape == (1,)
    if int(inf[0]):
        assert not xy.any()
        return JG2.infinity()
    return JG2.from_bytes(
        engine._g2_from_words(xy.numpy()).to_bytes(), subgroup_check=False)


@pytest.mark.parametrize("case", ["jax_test_48bit", "full_255bit"])
def test_msm_plain_matches_host(case):
    if case == "jax_test_48bit":
        args, expect = _msm_case(3, 8, 48, 5, 1 << 48)
    else:
        args, expect = _msm_case(17, 4, 255, 4, R)
    xy, inf = msm.msm(*args)
    assert xy.shape == (2, 2, NWORDS) and xy.dtype == torch.int32
    assert not expect.is_infinity()
    assert _msm_point(xy, inf) == expect


def test_msm_wrapper_on_cpu_is_plain_and_uncounted():
    args, _ = _msm_case(3, 8, 8, 5, 1 << 8)
    before = dict(msm.LAUNCHES)
    got = msm.msm(*args)
    want = msm.msm_plain(*args)
    assert msm.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["all_masked", "cancelling", "doubling"])
def test_msm_plain_edge_sums(case):
    """Infinity from an all-masked input and from P + (-P); a fold whose
    two halves are equal (the doubling case of the complete addition)."""
    g = PointG2.generator()
    p = g.mul(0x1234567)
    pts = {"all_masked": [p, p], "cancelling": [p, -p],
           "doubling": [p, p]}[case]
    mask = [1, 1] if case == "all_masked" else [0, 0]
    arr = np.stack([engine._g2_xy(q.to_affine()) for q in pts])
    bits = np.stack([jcurve.scalar_to_bits(5, 6)] * 2).astype(np.int32)
    xy, inf = msm.msm(torch.from_numpy(arr),
                      torch.tensor(mask, dtype=torch.int32),
                      torch.from_numpy(bits))
    expect = JG2.infinity() if case != "doubling" else \
        JG2.from_bytes(p.mul(10).to_bytes())
    assert _msm_point(xy, inf) == expect


@pytest.fixture(scope="module", params=[8, 5], ids=["8_lanes", "5_lanes"])
def stacked(request):
    """Two sums over one mask and one set of 16-bit scalars, as the
    wire-RLC combine stacks its signatures and messages: point i of sum j
    is [a_ij]g, lane 2 masked, lanes 0 and 1 of each sum equal (point and
    scalar). Returns the stacked inputs and each sum's host Σ (the JAX
    host's generator times Σ s_i·a_ij)."""
    b = request.param
    rnd = random.Random(29 + b)
    g = PointG2.generator()
    logs = [[rnd.randrange(1, R) for _ in range(b)] for _ in range(2)]
    scal = [rnd.randrange(1, 1 << 16) for _ in range(b)]
    for row in logs:
        row[1] = row[0]
    scal[1] = scal[0]
    mask = [int(i == 2) for i in range(b)]
    pts = np.stack([np.stack([engine._g2_xy(g.mul(a).to_affine())
                              for a in row]) for row in logs])
    bits = np.stack([jcurve.scalar_to_bits(c, 16) for c in scal])
    expect = [JG2.generator().mul(sum(c * a for c, a, m in
                                      zip(scal, row, mask) if not m) % R)
              for row in logs]
    args = (torch.from_numpy(pts), torch.tensor(mask, dtype=torch.int32),
            torch.from_numpy(bits.astype(np.int32)))
    return args, expect


def test_msm_stacked_equals_single_calls_and_host(stacked):
    """msm on (2, b, 2, 2, 12) gives both sums at once: each equals the
    call of its own sum and the host Σ."""
    (pts, mask, bits), expect = stacked
    xy, inf = msm.msm(pts, mask, bits)
    assert xy.shape == (2, 2, 2, NWORDS) and inf.shape == (2, 1)
    for j in range(2):
        one_xy, one_inf = msm.msm(pts[j].contiguous(), mask, bits)
        assert torch.equal(xy[j], one_xy) and torch.equal(inf[j], one_inf)
        assert _msm_point(xy[j], inf[j]) == expect[j]


@pytest.mark.parametrize("bad", ["four_dims", "six_dims", "no_sums",
                                 "lanes", "words"])
def test_msm_rejects_malformed_stacked_shapes(bad, stacked):
    (pts, mask, bits), _ = stacked
    b = pts.shape[1]
    shape = {"four_dims": (2, b, 2, NWORDS),
             "six_dims": (1, 2, b, 2, 2, NWORDS),
             "no_sums": (0, b, 2, 2, NWORDS),
             "lanes": (2, b + 1, 2, 2, NWORDS),
             "words": (2, b, 2, 2, NWORDS - 1)}[bad]
    with pytest.raises(ValueError):
        msm.msm(torch.zeros(shape, dtype=torch.int32), mask, bits)


def _horner_commits(t: int, b: int):
    """The JAX test's dealers: commitment k of dealer d is
    [97d + 13k + 1]·g; returned as JAX polys and the JAX engine's (t, b,
    32) commitment limbs."""
    g = JG1.generator()
    polys = [JPubPoly([g.mul(97 * d + 13 * k + 1) for k in range(t)])
             for d in range(b)]
    xs = np.zeros((t, b, 32), np.int32)
    ys = np.zeros((t, b, 32), np.int32)
    flat = JG1.batch_to_affine([c for p in polys for c in p.commits])
    for d in range(b):
        for k in range(t):
            xs[k, d], ys[k, d] = _g1_xy(flat[d * t + k])
    return polys, xs, ys


def _horner_points(xyz, inf, n):
    """Horner rows -> JAX host points, through the port's and the JAX
    engine's unpacking; both must agree."""
    ours = engine.BatchedEngine._unpack_eval_host(xyz.numpy(), inf.numpy(), n)
    rows = convert.eval_rows_to_jax(xyz, inf.numpy())
    theirs = JEngine._unpack_eval_host(rows, 3, n)
    ours = [JG1.from_bytes(p.to_bytes(), subgroup_check=False) for p in ours]
    assert ours == theirs
    return theirs


@pytest.mark.parametrize("affine", [False, True])
def test_horner_plain_matches_host_on_jax_test_inputs(affine):
    t, b, index = 3, 4, 6
    polys, xs, ys = _horner_commits(t, b)
    bits = jcurve.scalar_to_bits(index + 1, 10)      # shared, as the JAX test
    commits, lane_bits = convert.eval_inputs_from_jax(xs, ys, bits)
    assert lane_bits.shape == (b, 10)
    xyz, inf = ev.horner(commits, lane_bits, affine)
    assert xyz.shape == (b, 3, NWORDS) and inf.shape == (b,)
    assert _horner_points(xyz, inf, b) == [p.eval(index).value for p in polys]
    if affine:
        assert all(engine.fp_from_words(z) == 1 for z in xyz[:, 2].numpy())


def test_horner_plain_eleven_bit_indices_per_lane():
    """Per-lane indices up to 1023 (abscissa 1024 needs 11 bits, past the
    reference kernel's 10), one polynomial on every lane as
    eval_poly_indices sends it."""
    t = 3
    polys, xs, ys = _horner_commits(t, 1)
    idx = [1023, 1022, 0, 511, 700]
    b = len(idx)
    xs, ys = np.repeat(xs, b, axis=1), np.repeat(ys, b, axis=1)
    bits = np.stack([jcurve.scalar_to_bits(i + 1, 11) for i in idx])
    xyz, inf = ev.horner(*convert.eval_inputs_from_jax(xs, ys, bits))
    assert _horner_points(xyz, inf, b) == [polys[0].eval(i).value
                                           for i in idx]


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrappers_check_their_inputs(bad):
    args, _ = _msm_case(3, 8, 8, 5, 1 << 8)
    pts, mask, bits = args
    com = torch.zeros((2, 3, 2, NWORDS), dtype=torch.int32)
    hb = torch.zeros((3, 11), dtype=torch.int32)
    if bad == "dtype":
        pts, com = pts.to(torch.int64), com.to(torch.int64)
        err = TypeError
    elif bad == "shape":
        mask, hb = mask[:4], hb[:2]
        err = ValueError
    else:
        bits = torch.zeros((8, 16), dtype=torch.int32)[:, ::2]
        hb = torch.zeros((3, 22), dtype=torch.int32)[:, ::2]
        err = ValueError
    with pytest.raises(err):
        msm.msm(pts, mask, bits)
    with pytest.raises(err):
        ev.horner(com, hb)
