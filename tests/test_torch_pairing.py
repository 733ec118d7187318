"""The port's pairing module (drand_tpu_torch.ops.pairing), which holds
the two CUDA kernels: here their plain versions, held exactly against
the JAX package — the GT value of ``drand_tpu.crypto.pairing.
multi_pairing(canonical=False)`` (what tests/test_pallas_pairing.py holds
the Pallas chain to), verdicts, ``pallas_pairing``'s bit tables and its
packed input layout."""

import numpy as np
import pytest
import torch

from drand_tpu.crypto import bls as jbls
from drand_tpu.crypto.curves import PointG1 as JG1, PointG2 as JG2
from drand_tpu.crypto.hash_to_curve import hash_to_g2 as jhash
from drand_tpu.crypto.pairing import multi_pairing
from drand_tpu.ops import engine as jengine
from drand_tpu.ops import pallas_pairing as jpp
from drand_tpu_torch.ops import convert, limb as L, pairing as pp

# The plain versions run thousands of tiny tensor ops: one intra-op thread
# per test worker, or six workers' thread pools thrash the cores.
torch.set_num_threads(1)

SK = 0x1D2C3B


@pytest.fixture(scope="module")
def packed():
    """Two checks, packed by the JAX engine and by the port: row 0 valid,
    row 1 with a signature over another message."""
    pub = JG1.generator().mul(SK)
    h = jhash(b"torch-pairing-ok")
    sig_ok = JG2.from_bytes(jbls.sign(SK, b"torch-pairing-ok"))
    sig_bad = JG2.from_bytes(jbls.sign(SK, b"torch-pairing-other"))
    pub_aff = np.stack([jengine._g1_aff(pub)] * 2)
    sig_aff = np.stack([jengine._g2_aff(sig_ok), jengine._g2_aff(sig_bad)])
    msg_aff = np.stack([jengine._g2_aff(h)] * 2)
    port_in = pp.pack_verify_inputs(
        *convert.engine_batch_from_jax(pub_aff, sig_aff, msg_aff))
    return {"pub": pub, "h": h, "sig_bad": sig_bad,
            "jax_packed": (pub_aff, sig_aff, msg_aff), "port_in": port_in}


@pytest.fixture(scope="module")
def checks(packed):
    """Both checks through the wrappers on CPU tensors (K1 and K2's plain
    versions)."""
    launches = dict(pp.LAUNCHES)
    gt, ok = pp.final_exp_verdict(pp.miller_loop(*packed["port_in"]))
    return dict(packed, gt=gt, ok=ok,
                launches_moved=pp.LAUNCHES != launches)


def _gt_ints(x):
    return [c for c6 in (x.c0, x.c1) for c2 in (c6.c0, c6.c1, c6.c2)
            for c in (c2.c0, c2.c1)]


def test_gt_equals_multi_pairing(checks):
    """A non-verifying product: the port's GT value is the JAX package's
    multi_pairing(canonical=False), Fp12 for Fp12."""
    want = multi_pairing([(-JG1.generator(), checks["sig_bad"]),
                          (checks["pub"], checks["h"])], canonical=False)
    got = L.unpack_ints(checks["gt"][1]).reshape(-1).tolist()
    assert not want.is_one()
    assert got == _gt_ints(want)


def test_valid_product_is_exactly_one(checks):
    one = [1] + [0] * 11
    assert L.unpack_ints(checks["gt"][0]).reshape(-1).tolist() == one
    assert checks["ok"][0].item() == 1


def test_wrong_signature_rejected(checks):
    assert checks["ok"].tolist() == [1, 0]
    assert checks["ok"].dtype == torch.int32


def test_verify_prepared_plain_row(packed):
    """The plain chain on engine-packed rows (here the wrong-signature
    row alone) gives the verdict the wrappers gave."""
    pub, sig, msg = convert.engine_batch_from_jax(
        *(a[1:] for a in packed["jax_packed"]))
    assert pp.verify_prepared_plain(pub, sig, msg).tolist() == [False]


def test_cpu_tensors_take_the_plain_versions(checks):
    """CPU tensors never reach a kernel: no launch is counted."""
    assert not checks["launches_moved"]


@pytest.mark.parametrize("table", ["MILLER_FLAGS", "BITS_X", "BITS_XM1",
                                   "PM2"])
def test_bit_tables_match_pallas(table):
    mine = getattr(pp, table)
    theirs = jpp.PM2_FLAT[0] if table == "PM2" else getattr(jpp, table)[0]
    assert np.array_equal(mine, np.asarray(theirs, dtype=np.int32))


def test_bit_counts_match_pallas():
    assert (pp.N_MILLER, pp.N_X, pp.N_XM1) == (jpp.N_MILLER, jpp.N_X,
                                                jpp.N_XM1)
    assert pp.N_PM2 == jpp.bl.PM2_NBITS


def test_inputs_convert_from_pallas_layout(packed):
    """pallas_pairing.pack_verify_inputs (batch-last 12-bit limbs) and the
    port's pack_verify_inputs give the same kernel inputs."""
    xp, yp, q = jpp.pack_verify_inputs(*packed["jax_packed"])
    got = convert.verify_inputs_from_jax(np.asarray(xp), np.asarray(yp),
                                         np.asarray(q))
    for mine, theirs in zip(packed["port_in"], got):
        assert torch.equal(mine, theirs)


def test_kernel_consts_layout():
    """The constant buffer has the size of fp.cuh's struct Consts."""
    c = pp.kernel_consts()
    assert c.dtype == np.int32
    assert c.shape == (8 + 12 + 12 + 2 * 144 + 3 * 64 + 384,)
    assert L.words_to_int(c[8:20]) == jpp.P


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_inputs(packed, bad):
    xp, yp, q = packed["port_in"]
    if bad == "dtype":
        xp, err = xp.to(torch.int64), TypeError
    elif bad == "shape":
        q, err = q[:, :1].contiguous(), ValueError
    else:
        xp, err = xp.transpose(0, 1).contiguous().transpose(0, 1), ValueError
    with pytest.raises(err):
        pp.miller_loop(xp, yp, q)
