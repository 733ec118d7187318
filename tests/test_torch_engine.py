"""Slice 1 as a whole: the port's BatchedEngine on the CPU (the kernels'
plain versions) gives the JAX package's host verdicts, bit for bit —
the pattern of tests/test_batch_engine.py::test_host_and_device_agree —
and moves the device meters by the JAX engine's rule (engine.py:94-98):
one product check and two Miller pairs per row, per public call."""

import numpy as np
import pytest
import torch

from drand_tpu.chain import beacon as jbeacon
from drand_tpu.crypto import bls as jbls, tbls as jtbls
from drand_tpu.crypto.poly import PriPoly as JPriPoly
from drand_tpu_torch import metrics
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.ops import convert
from drand_tpu_torch.ops.engine import BatchedEngine

# The plain versions run thousands of tiny tensor ops: one intra-op thread
# per test worker, or six workers' thread pools thrash the cores.
torch.set_num_threads(1)

UNDECODABLE = b"\xff" * 96


@pytest.fixture(scope="module")
def group():
    poly = JPriPoly.random(3, seed=b"torch-engine-group")
    return poly, poly.commit()


@pytest.fixture(scope="module")
def engine():
    return BatchedEngine(device="cpu", buckets=(4,))


@pytest.fixture(scope="module")
def span(group):
    """A 4-round dual span: V1 of round 2 signs another message, V2 of
    round 3 is another round's, V1 of round 4 does not decode."""
    poly, _ = group
    secret = poly.secret()
    prev, beacons = b"torch-engine-genesis", []
    for r in range(1, 5):
        sig = jbls.sign(secret, jbeacon.message(r, prev))
        beacons.append(jbeacon.Beacon(
            round=r, previous_sig=prev, signature=sig,
            signature_v2=jbls.sign(secret, jbeacon.message_v2(r))))
        prev = sig
    beacons[1].signature = jbls.sign(secret, b"not round 2")
    beacons[2].signature_v2 = beacons[0].signature_v2
    beacons[3].signature = UNDECODABLE
    return beacons


def test_verify_beacons_matches_host(group, engine, span):
    _, pub_poly = group
    want = [jbeacon.verify_beacon(pub_poly.commit(), b)
            and jbeacon.verify_beacon_v2(pub_poly.commit(), b) for b in span]
    assert want == [True, False, False, False]
    port_span = [Beacon(round=b.round, previous_sig=b.previous_sig,
                        signature=b.signature, signature_v2=b.signature_v2)
                 for b in span]
    key = convert.g1_from_jax(pub_poly.commit())
    checks, pairs = metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS
    got = engine.verify_beacons(key, port_span)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    assert got.tolist() == want
    assert metrics.N_PRODUCT_CHECKS - checks == 1
    assert metrics.N_MILLER_PAIRS - pairs == 2 * 8


def test_verify_partials_matches_host(group, engine):
    poly, pub_poly = group
    msg = jbeacon.message_v2(7)
    partials = [jtbls.sign_partial(s, msg) for s in poly.shares(4)]
    partials[2] = jtbls.sign_partial(poly.eval(2), b"another round")
    want = [jtbls.verify_partial(pub_poly, msg, p) for p in partials]
    assert want == [True, True, False, True]
    checks, pairs = metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS
    got = engine.verify_partials(convert.pub_poly_from_jax(pub_poly), msg,
                                 partials)
    assert got == want
    assert metrics.N_PRODUCT_CHECKS - checks == 1
    assert metrics.N_MILLER_PAIRS - pairs == 2 * 4


def test_known_answer_gate_ran_per_bucket(engine):
    engine.check_bucket(4)              # a no-op once the gate has passed
    assert engine.introspect()["kat"]["verify"] == {"4": True}
    assert engine.introspect()["backend"] == "cpu"
