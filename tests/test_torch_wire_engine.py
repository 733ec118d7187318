"""The port's wire tiers as a whole, on the CPU (the kernels' plain
versions): ``verify_wire``, ``verify_wire_rlc`` and ``verify_beacons``
routed through them give the JAX package's host verdicts
(``chain.beacon.verify_beacon``/``verify_beacon_v2``), after the matrix of
``tests/test_wire_rlc.py``: a lane that does not decode is left out of
the combination, a bad signature makes the combined check fail and the
per-item wire path decide, and the meters move by the JAX engine's rule.
A known-answer gate given a wrong kernel result raises — where the JAX
engine disables the shape silently. One engine with ``buckets=(4,)``
serves the module; every span fits one bucket."""

import numpy as np
import pytest
import torch

from drand_tpu.chain import beacon as jbeacon
from drand_tpu.crypto import bls as jbls
from drand_tpu.crypto.poly import PriPoly as JPriPoly
from drand_tpu_torch import metrics
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.crypto.curves import PointG2
from drand_tpu_torch.ops import convert, wire
from drand_tpu_torch.ops.engine import BatchedEngine, _g2_xy

torch.set_num_threads(1)

UNDECODABLE = b"\x80" + b"\xff" * 95       # c1 >= p: sigs_to_x rejects it


@pytest.fixture(scope="module")
def group():
    poly = JPriPoly.random(3, seed=b"torch-wire-engine-group")
    return poly.secret(), poly.commit().commit()


@pytest.fixture(scope="module")
def engine():
    eng = BatchedEngine(device="cpu", buckets=(4,), wire_prep=True)
    eng.rlc_min = 2
    return eng


def _span(secret, n: int, v2: bool):
    prev, out = b"torch-wire-engine-genesis", []
    for r in range(1, n + 1):
        sig = jbls.sign(secret, jbeacon.message(r, prev))
        out.append(jbeacon.Beacon(
            round=r, previous_sig=prev, signature=sig,
            signature_v2=jbls.sign(secret, jbeacon.message_v2(r)) if v2
            else b""))
        prev = sig
    return out


def _port(span):
    return [Beacon(round=b.round, previous_sig=b.previous_sig,
                   signature=b.signature, signature_v2=b.signature_v2)
            for b in span]


def _host(pub, span):
    return [jbeacon.verify_beacon(pub, b)
            and (not b.signature_v2 or jbeacon.verify_beacon_v2(pub, b))
            for b in span]


def _meters():
    return metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS


def test_wire_rlc_leaves_out_an_undecodable_lane(group, engine):
    """Two V1 beacons, the second undecodable: the combination leaves it
    out, holds for the first, and the span costs one product check of
    two Miller pairs."""
    secret, pub = group
    span = _span(secret, 2, v2=False)
    span[1].signature = UNDECODABLE
    want = _host(pub, span)
    assert want == [True, False]
    assert engine.wire_rlc_active(2)
    c0, p0 = _meters()
    got = engine.verify_beacons(convert.g1_from_jax(pub), _port(span))
    c1, p1 = _meters()
    assert isinstance(got, np.ndarray) and got.dtype == bool
    assert got.tolist() == want
    assert (c1 - c0, p1 - p0) == (1, 2)
    kat = engine.introspect()["kat"]
    assert kat["wire_rlc"] == {"4": True} and kat["verify"] == {"4": True}


def test_bad_signature_falls_back_to_per_item_wire(group, engine,
                                                   monkeypatch):
    """Two dual beacons, the second's V2 signature the first's: the
    combined check fails, ``verify_wire_rlc`` returns None, and the
    per-item wire path gives the exact verdicts."""
    secret, pub = group
    span = _span(secret, 2, v2=True)
    span[1].signature_v2 = span[0].signature_v2
    want = _host(pub, span)
    assert want == [True, False]
    seen = []
    real = engine.verify_wire_rlc

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(engine, "verify_wire_rlc", spy)
    c0, p0 = _meters()
    got = engine.verify_beacons(convert.g1_from_jax(pub), _port(span))
    c1, p1 = _meters()
    assert seen == [None]
    assert got.tolist() == want
    # the combined row, then 4 per-item rows of two Miller pairs
    assert (c1 - c0, p1 - p0) == (2, 2 + 2 * 4)
    assert engine.introspect()["kat"]["wire"] == {"4": True}


def _wrong_combine(u, x, sign, live, bits):
    """A combine that returns the generator for both sums."""
    gen = torch.from_numpy(_g2_xy(PointG2.generator().to_affine()))
    zero = torch.zeros(1, dtype=torch.int32)
    return live != 0, (gen, zero), (gen, zero)


@pytest.mark.parametrize("gate", ["wire", "wire_rlc"])
def test_gate_given_a_wrong_kernel_result_raises(gate, monkeypatch):
    eng = BatchedEngine(device="cpu", buckets=(4,), wire_prep=True)
    if gate == "wire":
        eng.rlc_min = 1 << 20            # no RLC attempt: straight to wire
        monkeypatch.setattr(wire, "verify_wire_prepared",
                            lambda pub, u, x, sign: torch.ones(
                                u.shape[0], dtype=torch.bool))
    else:
        eng.rlc_min = 2
        monkeypatch.setattr(wire, "wire_rlc_combine", _wrong_combine)
    checks = [(b"m%d" % i, PointG2.generator().to_bytes()) for i in range(2)]
    with pytest.raises(RuntimeError, match="known-answer"):
        eng.verify_beacons(convert.g1_from_jax(
            JPriPoly.random(1, seed=b"k").commit().commit()),
            [Beacon(round=i + 1, previous_sig=b"p", signature=s)
             for i, (_, s) in enumerate(checks)])
    assert eng.introspect()["kat"][gate] == {"4": False}


@pytest.mark.parametrize("wire_prep,n,active", [
    (True, 1, False), (True, 2, True), (True, 600, True),
    (None, 8, False), (None, 31, False), (None, 32, True),
    (False, 2048, False)])
def test_wire_rlc_active(wire_prep, n, active):
    eng = BatchedEngine(device="cpu", buckets=(4,), wire_prep=wire_prep)
    eng.rlc_min = 2
    assert eng.wire_rlc_active(n) is active


def test_introspect_lists_the_wire_tiers():
    eng = BatchedEngine(device="cpu", wire_prep=None)
    got = eng.introspect()
    assert got["wire_buckets"] == [4, 128, 512]
    assert got["wire_prep"] is None and got["rlc_min"] == 8
    assert got["kat"]["wire"] == {} and got["kat"]["wire_rlc"] == {}
    assert "prep" in got["stage_seconds"]
