"""Drive the PyTorch/CUDA port (``drand_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``drand_tpu_torch/csrc`` (one nvcc per
source, all started together) and runs these phases, printing one JSON
line each:

1. ``build``     — nvcc build times, ptxas registers and spills per
                   kernel, the card's name and power limit;
2. ``kernels``   — every kernel against its plain PyTorch version on the
                   card, word for word, at the shapes of the paths below:
                   K1 (Miller loop) and K2 (final exponentiation +
                   verdict) at 512 and 128 lanes; the G2 MSM with GLS4
                   digit scalars at 512 lanes and with 255-bit scalars at
                   128 lanes (its own point and scalar on every lane, two
                   lanes alike so that the fold doubles, masked lanes) and
                   and at the 6-of-10 round's 32 lanes, and on an
                   all-masked input; the G1 Horner at 128 lanes, t = 65,
                   per-lane 11-bit indices, in both output forms, and in
                   the fused round's form (Z = 1) on the inputs of the
                   67-of-100 and 6-of-10 rounds; with their times and the
                   time bound of their integer work;
3. ``catchup``   — ``BatchedEngine.verify_beacons`` over 1024 rounds of a
                   chained beacon that also carries V2 signatures, under
                   one 6-of-10 group key, with one V1 and one V2
                   signature corrupted (four launches of K1 and K2);
4. ``live_round`` — the League of Entropy round (6 of 10) through
                   ``aggregate_round``, once with every partial valid and
                   once with one chosen partial signing another message
                   (the classic tail), each on a fresh ``PubPoly``;
5. ``threshold_round`` — the same at 67 of 100 (BASELINE config 3);
6. ``deal_check`` — ``eval_commits`` of 128 dealers' t = 65 commitment
                   polynomials at one node index (BASELINE config 4).

Each path's launches are counted from zero just before it runs, after the
engine's known-answer gates, and checked exactly. Then a ``summary``
line, a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and, if every phase passed, the last line
``{"ok": true, "device": {...}}``. Any failed phase, a machine without
CUDA, or a directory without the package makes it exit non-zero without
that line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import random
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

SEED = 20260
N_ROUNDS = 1024
GROUP_T, GROUP_N = 6, 10          # League of Entropy: threshold 6 of 10
GROUP_TAG = b"chip-smoke-group"   # seed of the group polynomial
BAD_V1, BAD_V2 = 137, 801         # beacon indices whose V1 / V2 is corrupted
BAD_PARTIAL = 3                   # share index of the corrupted partial
MAIN_BUCKET = 512                 # the catch-up span's bucket
LIVE_BUCKET = 128                 # the live round's bucket (10 partials)
BIG_T, BIG_N = 67, 100            # BASELINE config 3: 67-of-100 threshold
BIG_TAG = b"chip-smoke-group-67-of-100"
BIG_BAD = 10                      # a corrupted partial among the first 67
DEALERS, DEAL_T = 128, 65         # BASELINE config 4: n = 128 deal check
DEAL_INDEX = 37                   # the node index the deals are checked at
MSM_GLS4_LANES, MSM_FULL_LANES = 512, 128
HORNER_LANES = 128
EVAL_BITS = 11
TIMED_LAUNCHES = 5
GENERATE_TIMEOUT_S = 400

# H100 SXM integer rate for the bound: 64 INT32 lanes per SM (Hopper white
# paper) x 132 SMs x 1.98 GHz boost (the clock behind the 67 TFLOP/s
# float32 peak of the H100 SXM data sheet). One 32x32->64 multiply-
# add is counted as two int32 multiply-adds (low and high word).
INT32_MAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
MAD_PER_FP_PRODUCT = 2 * 288 + 12   # CIOS: 144 product + 144 reduction
                                    # wide MADs, 12 m = t0·n0 multiplies


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# data generation (pool workers: spawn, plain functions of this module)
# ---------------------------------------------------------------------------

def _group_secret() -> tuple[int, bytes]:
    from drand_tpu_torch.crypto.poly import PriPoly

    poly = PriPoly.random(GROUP_T, seed=GROUP_TAG)
    return poly.secret(), b"chip-smoke-genesis"


def _sign_v1_chain(n_rounds: int) -> list[tuple[bytes, bytes]]:
    """(previous_sig, signature) of rounds 1..n_rounds, chained."""
    from drand_tpu_torch.chain import beacon as cb
    from drand_tpu_torch.crypto import bls

    secret, prev = _group_secret()
    out = []
    for r in range(1, n_rounds + 1):
        sig = bls.sign(secret, cb.message(r, prev))
        out.append((prev, sig))
        prev = sig
    return out


def _sign_v2(rounds: list[int]) -> list[bytes]:
    from drand_tpu_torch.chain import beacon as cb
    from drand_tpu_torch.crypto import bls

    secret, _ = _group_secret()
    return [bls.sign(secret, cb.message_v2(r)) for r in rounds]


def make_chain(n_rounds: int, workers: int):
    """1024 beacons signed with the group secret (the recovered group
    signature of every round): the V1 chain in one worker, the V2
    signatures spread over the others."""
    from drand_tpu_torch.chain.beacon import Beacon

    rounds = list(range(1, n_rounds + 1))
    n_v2 = max(1, workers - 1)
    chunks = [rounds[i::n_v2] for i in range(n_v2)]
    ctx = multiprocessing.get_context("spawn")
    # a worker that dies raises BrokenProcessPool here instead of hanging
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        v1 = pool.submit(_sign_v1_chain, n_rounds)
        v2 = [pool.submit(_sign_v2, c) for c in chunks]
        v1_sigs = v1.result(timeout=GENERATE_TIMEOUT_S)
        v2_sigs = {}
        for c, fut in zip(chunks, v2):
            v2_sigs.update(zip(c, fut.result(timeout=GENERATE_TIMEOUT_S)))
    return [Beacon(round=r, previous_sig=v1_sigs[r - 1][0],
                   signature=v1_sigs[r - 1][1], signature_v2=v2_sigs[r])
            for r in rounds]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

KERNEL_NAMES = {"pairing": ("miller_loop_kernel", "final_exp_verdict_kernel"),
                "msm": ("msm_ladder_fold_kernel", "msm_final_kernel"),
                "eval": ("eval_horner_kernel",)}


def phase_build(state) -> dict:
    from drand_tpu_torch.ops import _build

    t0 = time.perf_counter()
    infos = _build.build_all()
    kernels = {}
    for lib, names in KERNEL_NAMES.items():
        for mangled, props in infos[lib]["kernels"].items():
            for short in names:
                if short in mangled:
                    kernels[short] = props
    want = {k for names in KERNEL_NAMES.values() for k in names}
    if set(kernels) != want:
        raise RuntimeError(f"ptxas reported {sorted(kernels)}, want "
                           f"{sorted(want)}")
    return {"build_seconds": {k: v["build_seconds"] for k, v in infos.items()},
            "wall_seconds": time.perf_counter() - t0,
            "ptxas": kernels, "card": state["card"]}


def _kernel_inputs(device, n_lanes: int):
    """n_lanes checks from SEED, each with its own secret key; the
    messages repeat with period 16. Lanes 0-7 of every 16 are valid,
    8-15 signed with sk+1. Also returns the host oracle's GT value (the
    cube of the pairing product, as K2 computes it) of lane 8, as 12
    canonical ints."""
    import numpy as np
    import torch

    from drand_tpu_torch.crypto.curves import PointG1
    from drand_tpu_torch.crypto.fields import R
    from drand_tpu_torch.crypto.hash_to_curve import hash_to_g2
    from drand_tpu_torch.crypto.pairing import multi_pairing
    from drand_tpu_torch.ops.limb import fp_words

    rng = random.Random(SEED)
    hashes = [hash_to_g2(b"chip-smoke-kernel-%d" % i) for i in range(16)]
    pubs, sigs, msgs = [], [], []
    for i in range(n_lanes):
        sk = rng.randrange(1, R)
        h = hashes[i % 16]
        sig = h.mul(sk if i % 16 < 8 else sk + 1)
        pub = PointG1.generator().mul(sk)
        if i == 8:
            gt = multi_pairing([(-PointG1.generator(), sig), (pub, h)],
                               canonical=False)
            oracle = [c for c6 in (gt.c0, gt.c1)
                      for c2 in (c6.c0, c6.c1, c6.c2) for c in (c2.c0, c2.c1)]
        x, y = pub.to_affine()
        pubs.append(np.stack([fp_words(x.v), fp_words(y.v)]))
        for pt, out in ((sig, sigs), (h, msgs)):
            qx, qy = pt.to_affine()
            out.append(np.stack([np.stack([fp_words(qx.c0), fp_words(qx.c1)]),
                                 np.stack([fp_words(qy.c0), fp_words(qy.c1)])]))
    expect = [int(i % 16 < 8) for i in range(n_lanes)]
    return ([torch.from_numpy(np.stack(a)).to(device)
             for a in (pubs, sigs, msgs)], expect, oracle)


def _time_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _time_once_ms(fn):
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def _against_plain(pp, field, xp, yp, q) -> dict:
    """K1 and K2 on (xp, yp, q), and their plain versions on the same
    inputs; the errors, outputs, plain times and Fp products per check."""
    import torch

    b = xp.shape[0]
    f_k = pp.miller_loop(xp, yp, q)
    field.N_FP_PRODUCTS = 0
    f_p, k1_plain_ms = _time_once_ms(lambda: pp.miller_loop_plain(xp, yp, q))
    k1_products = field.N_FP_PRODUCTS / b
    gt_k, ok_k = pp.final_exp_verdict(f_k)
    field.N_FP_PRODUCTS = 0
    (gt_p, ok_p), k2_plain_ms = _time_once_ms(lambda: pp.final_exp_plain(f_k))
    k2_products = field.N_FP_PRODUCTS / b
    torch.cuda.synchronize()
    return {"k1_err": _max_abs_err(f_k, f_p),
            "k2_err": max(_max_abs_err(gt_k, gt_p), _max_abs_err(ok_k, ok_p)),
            "f": f_k, "gt": gt_k, "ok": ok_k,
            "k1_plain_ms": k1_plain_ms, "k2_plain_ms": k2_plain_ms,
            "k1_products": k1_products, "k2_products": k2_products}


def _bound_ms(products: float, nbytes: int):
    """(bound ms, what bounds it): the larger of the Fp products' integer
    multiply-adds at the card's int32 rate and the bytes at its memory
    rate."""
    ops_s = products * MAD_PER_FP_PRODUCT / INT32_MAD_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _pairing_kernels(state) -> dict:
    """K1 and K2 against their plain versions at the buckets of both
    paths: MAIN_BUCKET (the catch-up span) and LIVE_BUCKET (the live
    round), every lane with its own inputs."""
    from drand_tpu_torch.ops import field, pairing as pp
    from drand_tpu_torch.ops.limb import unpack_ints

    dev = state["device"]
    (pubs, sigs, msgs), expect, oracle = _kernel_inputs(dev, MAIN_BUCKET)
    xp, yp, q = pp.pack_verify_inputs(pubs, sigs, msgs)
    b = xp.shape[0]
    main = _against_plain(pp, field, xp, yp, q)
    xl, yl, ql = xp[:LIVE_BUCKET], yp[:LIVE_BUCKET], q[:LIVE_BUCKET]
    live = _against_plain(pp, field, xl, yl, ql)
    f_k, gt_k, ok_k = main["f"], main["gt"], main["ok"]

    verdicts_ok = (ok_k.cpu().tolist() == expect
                   and live["ok"].cpu().tolist() == expect[:LIVE_BUCKET])
    oracle_ok = all(unpack_ints(gt[8]).reshape(-1).tolist() == oracle
                    for gt in (gt_k, live["gt"]))
    k1_ms = _time_ms(lambda: pp.miller_loop(xp, yp, q), TIMED_LAUNCHES)
    k2_ms = _time_ms(lambda: pp.final_exp_verdict(f_k), TIMED_LAUNCHES)
    k1_live_ms = _time_ms(lambda: pp.miller_loop(xl, yl, ql), TIMED_LAUNCHES)
    k2_live_ms = _time_ms(lambda: pp.final_exp_verdict(live["f"]),
                          TIMED_LAUNCHES)

    k1_bound, k1_by = _bound_ms(main["k1_products"] * b,
                                _nbytes(xp, yp, q, f_k))
    k2_bound, k2_by = _bound_ms(main["k2_products"] * b,
                                _nbytes(f_k, gt_k, ok_k))
    state["kernels"] = {
        "miller_loop": {
            "name": "miller_loop_kernel", "route": "cuda",
            "source": "drand_tpu_torch/csrc/pairing.cu",
            "replaces": "drand_tpu/ops/pallas_pairing.py:335",
            "max_abs_err": max(main["k1_err"], live["k1_err"]),
            "ms": k1_ms, "plain_ms": main["k1_plain_ms"],
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
            "fp_products_per_check": main["k1_products"]},
        "final_exp_verdict": {
            "name": "final_exp_verdict_kernel", "route": "cuda",
            "source": "drand_tpu_torch/csrc/pairing.cu",
            "replaces": "drand_tpu/ops/pallas_pairing.py:376",
            "max_abs_err": max(main["k2_err"], live["k2_err"]),
            "ms": k2_ms, "plain_ms": main["k2_plain_ms"],
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
            "fp_products_per_check": main["k2_products"]},
    }
    errs = {f"{k}_at_{n}": r[k] for n, r in ((b, main), (LIVE_BUCKET, live))
            for k in ("k1_err", "k2_err")}
    if any(errs.values()) or not verdicts_ok or not oracle_ok:
        raise RuntimeError(f"kernel mismatch: {errs}, verdicts ok "
                           f"{verdicts_ok}, host oracle GT ok {oracle_ok}")
    live_ms = {"miller_loop": (k1_live_ms, live["k1_plain_ms"]),
               "final_exp_verdict": (k2_live_ms, live["k2_plain_ms"])}
    return {"batch": b, "live_batch": LIVE_BUCKET, "tolerance": 0,
            "errors": errs, "launches": dict(pp.LAUNCHES),
            "verdicts_match_expected": verdicts_ok,
            "gt_matches_host_oracle": oracle_ok,
            "kernels": [{"name": k["name"], "match": k["max_abs_err"] == 0,
                         "launches": pp.LAUNCHES[key],
                         "ms_at_512": k["ms"], "plain_ms_at_512": k["plain_ms"],
                         "ms_at_128": live_ms[key][0],
                         "plain_ms_at_128": live_ms[key][1],
                         "bound_ms": k["bound_ms"],
                         "fp_products_per_check": k["fp_products_per_check"]}
                        for key, k in state["kernels"].items()]}


def _launch_counts() -> dict:
    from drand_tpu_torch.ops import eval as ev, msm, pairing as pp

    return {**pp.LAUNCHES, **msm.LAUNCHES, **ev.LAUNCHES}


def _reset_launches() -> None:
    from drand_tpu_torch.ops import eval as ev, msm, pairing as pp

    for counts in (pp.LAUNCHES, msm.LAUNCHES, ev.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _point_products() -> dict:
    """Fp products of one doubling, one complete addition of distinct
    points and one to-affine, on G1 and G2, counted by the plain versions
    (the kernels follow the same formulas)."""
    import torch

    from drand_tpu_torch.crypto.curves import PointG1, PointG2
    from drand_tpu_torch.ops import curve as cv, field
    from drand_tpu_torch.ops.engine import _g1_xy, _g2_xy
    from drand_tpu_torch.ops.limb import words_to_halves

    out = {}
    for name, F, G, pack in (("g1", cv.F1, PointG1, _g1_xy),
                             ("g2", cv.F2, PointG2, _g2_xy)):
        pts = []
        for k in (1, 2):
            xy = words_to_halves(torch.from_numpy(
                pack(G.generator().mul(k).to_affine())))[None]
            pts.append((xy[:, 0], xy[:, 1], F.one((1,), "cpu"),
                        torch.zeros(1, dtype=torch.bool)))
        for op, fn in (("dbl", lambda: cv.pt_dbl(F, pts[0])),
                       ("add", lambda: cv.pt_add(F, pts[0], pts[1])),
                       ("aff", lambda: cv.pt_to_affine(F, pts[0]))):
            field.N_FP_PRODUCTS = 0
            fn()
            out[f"{name}_{op}"] = field.N_FP_PRODUCTS
    return out


def _ladder_products(k: int, dbl: int, add: int) -> int:
    """Fp products a double-and-add over k needs from its top bit."""
    return 0 if k == 0 else ((k.bit_length() - 1) * dbl
                             + (bin(k).count("1") - 1) * add)


def _msm_case(dev, rng, n_lanes: int, nbits: int, counts: dict) -> dict:
    """One MSM input from SEED: every lane its own point and scalar,
    lanes 16 and n/2 equal to lane 0 (so that the kernel's block fold and
    the plain fold both take the doubling case), every 7th lane and the
    last masked. Kernel against plain word for word, and the sum against
    the host's Σ s·P."""
    import numpy as np
    import torch

    from drand_tpu_torch.crypto.curves import PointG2
    from drand_tpu_torch.crypto.fields import R
    from drand_tpu_torch.ops import msm
    from drand_tpu_torch.ops.curve import scalar_to_bits
    from drand_tpu_torch.ops.engine import _g2_from_words, _g2_xy

    g = PointG2.generator()
    step, p = g.mul(rng.randrange(1, R)), g.mul(rng.randrange(1, R))
    pts = []
    for _ in range(n_lanes):
        pts.append(p)
        p = p + step
    top = R if nbits >= 255 else 1 << nbits
    scal = [rng.randrange(1, top) for _ in range(n_lanes)]
    for j in {min(16, n_lanes - 2), n_lanes // 2}:
        pts[j], scal[j] = pts[0], scal[0]
    mask = [int(i % 7 == 3 or i == n_lanes - 1) for i in range(n_lanes)]
    arr = np.stack([_g2_xy(xy) for xy in PointG2.batch_to_affine(pts)])
    bits = np.stack([scalar_to_bits(k, nbits) for k in scal])
    args = [torch.from_numpy(a).to(dev) for a in
            (arr, np.array(mask, np.int32), bits.astype(np.int32))]
    xy_k, inf_k = msm.msm(*args)
    (xy_p, inf_p), plain_ms = _time_once_ms(lambda: msm.msm_plain(*args))
    err = max(_max_abs_err(xy_k, xy_p), _max_abs_err(inf_k, inf_p))
    host = PointG2.infinity()
    for pt, k, m in zip(pts, scal, mask):
        if not m:
            host = host + pt.mul(k)
    got = _g2_from_words(xy_k.cpu().numpy())
    live = [k for k, m in zip(scal, mask) if not m]
    products = (sum(_ladder_products(k, counts["g2_dbl"], counts["g2_add"])
                    for k in live)
                + (len(live) - 1) * counts["g2_add"] + counts["g2_aff"])
    bound, by = _bound_ms(products, _nbytes(*args, xy_k, inf_k))
    return {"lanes": n_lanes, "nbits": nbits, "masked": sum(mask),
            "max_abs_err": err, "host_match": bool(got == host
                                                   and not inf_k.item()),
            "ms": _time_ms(lambda: msm.msm(*args), TIMED_LAUNCHES),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "fp_products": products}


def _dealers(state):
    """DEALERS commitment polynomials of DEAL_T coefficients, from SEED
    (built once, shared by the kernels and deal_check phases)."""
    if "dealers" not in state:
        from drand_tpu_torch.crypto.poly import PriPoly

        state["dealers"] = [
            PriPoly.random(DEAL_T, seed=b"chip-smoke-dealer-%d-%d"
                           % (SEED, d)).commit() for d in range(DEALERS)]
    return state["dealers"]


def _horner_case(state, rng, counts: dict) -> dict:
    """The Horner kernel against its plain version at HORNER_LANES lanes
    of the dealers' t = 65 polynomials, every lane at its own index (0
    to 1023, 11-bit abscissae), in both output forms; the first lanes
    also against the host's PubPoly.eval."""
    import numpy as np
    import torch

    from drand_tpu_torch.crypto.curves import PointG1
    from drand_tpu_torch.ops import eval as ev
    from drand_tpu_torch.ops.curve import scalar_to_bits
    from drand_tpu_torch.ops.engine import BatchedEngine, _g1_xy

    dev = state["device"]
    polys = _dealers(state)[:HORNER_LANES]
    t = len(polys[0].commits)
    idx = [1023, 0] + [rng.randrange(0, 1024) for _ in polys[2:]]
    flat = PointG1.batch_to_affine([c for p in polys for c in p.commits])
    com = np.stack([np.stack([_g1_xy(flat[d * t + k])
                              for d in range(len(polys))]) for k in range(t)])
    bits = np.stack([scalar_to_bits(i + 1, EVAL_BITS) for i in idx])
    com_d, bits_d = (torch.from_numpy(a.astype(np.int32)).to(dev)
                     for a in (com, bits))
    out = {"lanes": len(polys), "t": t, "nbits": EVAL_BITS}
    errs = {}
    for affine in (False, True):
        xyz_k, inf_k = ev.horner(com_d, bits_d, affine)
        (xyz_p, inf_p), plain_ms = _time_once_ms(
            lambda: ev.horner_plain(com_d, bits_d, affine))
        errs[f"affine_{affine}"] = max(_max_abs_err(xyz_k, xyz_p),
                                       _max_abs_err(inf_k, inf_p))
        got = BatchedEngine._unpack_eval_host(
            xyz_k.cpu().numpy(), inf_k.cpu().numpy(), 8)
        out[f"host_match_affine_{affine}"] = got == [
            p.eval(i).value for p, i in zip(polys[:8], idx[:8])]
        out[f"ms_affine_{affine}"] = _time_ms(
            lambda: ev.horner(com_d, bits_d, affine), TIMED_LAUNCHES)
        out[f"plain_ms_affine_{affine}"] = plain_ms
        products = (t - 1) * sum(
            _ladder_products(i + 1, counts["g1_dbl"], counts["g1_add"])
            + counts["g1_add"] for i in idx)
        if affine:
            products += len(idx) * counts["g1_aff"]
        out[f"bound_ms_affine_{affine}"], out["bound_by"] = _bound_ms(
            products, _nbytes(com_d, bits_d, xyz_k, inf_k))
        out[f"fp_products_affine_{affine}"] = products
    out["max_abs_err"] = max(errs.values())
    out["errors"] = errs
    return out


def _horner_round_case(dev, t: int, n: int, tag: bytes, counts: dict) -> dict:
    """The Horner kernel in the fused round's form (Z = 1) on the inputs
    ``aggregate_round`` gives it for a fresh t-of-n round: the round's
    commitment polynomial on every lane of the Horner bucket, lane j at
    share index j, pad lanes with zero bits (packed by the engine's own
    helpers). Kernel against plain word for word, and every share key
    against the host's PubPoly.eval."""
    from drand_tpu_torch.crypto.poly import PriPoly
    from drand_tpu_torch.ops import eval as ev
    from drand_tpu_torch.ops.engine import BatchedEngine

    eng = BatchedEngine(device=dev)
    poly = PriPoly.random(t, seed=tag).commit()
    b = eng._eval_bucket(n)
    com_d = eng._poly_commit_words(poly, b)
    bits_d = eng._index_bits(list(range(n)), b)
    xyz_k, inf_k = ev.horner(com_d, bits_d, True)
    (xyz_p, inf_p), plain_ms = _time_once_ms(
        lambda: ev.horner_plain(com_d, bits_d, True))
    err = max(_max_abs_err(xyz_k, xyz_p), _max_abs_err(inf_k, inf_p))
    got = BatchedEngine._unpack_eval_host(xyz_k.cpu().numpy(),
                                          inf_k.cpu().numpy(), n)
    products = sum((t - 1) * (_ladder_products(i + 1, counts["g1_dbl"],
                                               counts["g1_add"])
                              + counts["g1_add"]) + counts["g1_aff"]
                   for i in range(n))
    bound, by = _bound_ms(products, _nbytes(com_d, bits_d, xyz_k, inf_k))
    return {"lanes": b, "t": t, "indices": n, "affine": True,
            "max_abs_err": err,
            "host_match": got == [poly.eval(i).value for i in range(n)],
            "ms": _time_ms(lambda: ev.horner(com_d, bits_d, True),
                           TIMED_LAUNCHES),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "fp_products": products}


def _curve_kernels(state) -> dict:
    """The MSM and Horner kernels against their plain versions at the
    shapes of the rounds: the MSM with GLS4 digits at 512 lanes (67 of
    100) and 32 lanes (6 of 10), 255-bit scalars at 128 lanes and an
    all-masked input; the Horner at t = 65 with per-lane indices in both
    output forms, and in the fused form on both rounds' inputs. The
    kernels line reports each kernel at the shape and form of its
    launches on the 67-of-100 round."""
    import numpy as np
    import torch

    from drand_tpu_torch.crypto.curves import PointG2
    from drand_tpu_torch.ops import msm
    from drand_tpu_torch.ops.engine import _g2_xy, msm_lanes

    dev = state["device"]
    rng = random.Random(SEED + 1)
    counts = _point_products()
    gls4 = _msm_case(dev, rng, MSM_GLS4_LANES, 64, counts)
    full = _msm_case(dev, rng, MSM_FULL_LANES, 255, counts)
    live = _msm_case(dev, rng, msm_lanes(GROUP_T, True), 64, counts)
    gen = _g2_xy(PointG2.generator().to_affine())
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        np.broadcast_to(gen, (32,) + gen.shape), np.ones(32, np.int32),
        np.ones((32, 64), np.int32))]
    (xy_k, inf_k), (xy_p, inf_p) = msm.msm(*args), msm.msm_plain(*args)
    masked = {"max_abs_err": max(_max_abs_err(xy_k, xy_p),
                                 _max_abs_err(inf_k, inf_p)),
              "infinity": bool(inf_k.item())}
    horner = _horner_case(state, rng, counts)
    h_big = _horner_round_case(dev, BIG_T, BIG_N, BIG_TAG, counts)
    h_live = _horner_round_case(dev, GROUP_T, GROUP_N, GROUP_TAG, counts)
    msm_cases = (gls4, full, live, masked)
    horner_cases = (horner, h_big, h_live)
    # the shapes compared here, which the rounds' launches must have
    state["msm_shapes"] = {(c["lanes"], c["nbits"]) for c in msm_cases[:3]}
    state["fused_horner_shapes"] = {(c["t"], c["lanes"])
                                    for c in (h_big, h_live)}
    state["kernels"]["msm"] = {
        "name": "msm_ladder_fold_kernel+msm_final_kernel", "route": "cuda",
        "source": "drand_tpu_torch/csrc/msm.cu",
        "replaces": "drand_tpu/ops/pallas_msm.py:65",
        "max_abs_err": max(c["max_abs_err"] for c in msm_cases),
        "ms": gls4["ms"], "plain_ms": gls4["plain_ms"],
        "bound_ms": gls4["bound_ms"], "bound_by": gls4["bound_by"],
        "library_ms": None}
    state["kernels"]["horner"] = {
        "name": "eval_horner_kernel", "route": "cuda",
        "source": "drand_tpu_torch/csrc/eval.cu",
        "replaces": "drand_tpu/ops/pallas_eval.py:73",
        "max_abs_err": max(c["max_abs_err"] for c in horner_cases),
        "ms": h_big["ms"], "plain_ms": h_big["plain_ms"],
        "bound_ms": h_big["bound_ms"], "bound_by": h_big["bound_by"],
        "library_ms": None}
    out = {"tolerance": 0, "msm_gls4": gls4, "msm_full": full,
           "msm_live_round": live, "msm_all_masked": masked,
           "horner": horner, "horner_round_67_of_100": h_big,
           "horner_round_6_of_10": h_live, "point_products": counts}
    bad = (state["kernels"]["msm"]["max_abs_err"]
           or state["kernels"]["horner"]["max_abs_err"]
           or not all(c["host_match"] for c in (gls4, full, live, h_big,
                                                 h_live))
           or not masked["infinity"]
           or not all(horner[f"host_match_affine_{a}"] for a in (False, True)))
    if bad:
        raise RuntimeError(f"curve kernel mismatch: {out}")
    return out


def phase_kernels(state) -> dict:
    pairing = _pairing_kernels(state)
    curve = _curve_kernels(state)
    return {"pairing": pairing, "curve": curve,
            "launches": _launch_counts()}


def phase_catchup(state) -> dict:
    from drand_tpu_torch import metrics
    from drand_tpu_torch.crypto import bls
    from drand_tpu_torch.crypto.poly import PriPoly
    from drand_tpu_torch.ops.engine import BatchedEngine

    t0 = time.perf_counter()
    workers = max(2, min(8, os.cpu_count() or 2))
    beacons = make_chain(N_ROUNDS, workers)
    secret, _ = _group_secret()
    beacons[BAD_V1].signature = bls.sign(secret, b"not-this-round")
    beacons[BAD_V2].signature_v2 = beacons[BAD_V2 + 1].signature_v2
    gen_s = time.perf_counter() - t0
    group_key = PriPoly.random(GROUP_T, seed=GROUP_TAG).commit().commit()

    eng = BatchedEngine(device=state["device"])
    eng.check_bucket(MAIN_BUCKET)              # gate launches come first
    state["engine"] = eng
    for k in eng.stage_seconds:
        eng.stage_seconds[k] = 0.0
    checks0, pairs0 = metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS
    _reset_launches()
    t1 = time.perf_counter()
    verdicts = eng.verify_beacons(group_key, beacons)
    wall = time.perf_counter() - t1
    launches = _launch_counts()
    d_checks = metrics.N_PRODUCT_CHECKS - checks0
    d_pairs = metrics.N_MILLER_PAIRS - pairs0
    state["main_launches"] = launches

    bad = [i for i, v in enumerate(verdicts.tolist()) if not v]
    st = eng.stage_seconds
    out = {"rounds": N_ROUNDS, "checks": 2 * N_ROUNDS,
           "generate_seconds": gen_s, "false_at": bad,
           "meter_deltas": {"product_checks": d_checks, "miller_pairs": d_pairs},
           "launches": launches,
           "host_seconds": {"hash": st["hash"], "decode": st["decode"],
                            "pack": st["pack"]},
           "device_seconds": st["device"], "wall_seconds": wall,
           "device_pairs_per_s": d_pairs / st["device"] if st["device"] else None}
    expect_launches = {"miller_loop": 4, "final_exp_verdict": 4, "msm": 0,
                       "horner": 0}
    if bad != [BAD_V1, BAD_V2] or d_checks != 1 or d_pairs != 4 * N_ROUNDS \
            or launches != expect_launches:
        raise RuntimeError(f"catchup: {out}")
    return out


def _partials(poly, n: int, msg: bytes) -> list[bytes]:
    """Partials of shares 0..n-1 on msg: H(msg) hashed once, each share
    times it (what tbls.sign_partial computes, checked on share 0)."""
    from drand_tpu_torch.crypto import tbls
    from drand_tpu_torch.crypto.hash_to_curve import hash_to_g2

    h = hash_to_g2(msg)
    out = [s.index.to_bytes(tbls.INDEX_BYTES, "big") + h.mul(s.value).to_bytes()
           for s in poly.shares(n)]
    if out[0] != tbls.sign_partial(poly.eval(0), msg):
        raise RuntimeError("partials differ from tbls.sign_partial")
    return out


def _threshold_rounds(state, t: int, n: int, bad: int, tag: bytes,
                      round_no: int) -> dict:
    """A t-of-n round through ``aggregate_round`` twice, each on a fresh
    PubPoly (an empty share-key cache): every partial valid, then share
    ``bad`` (among the first t chosen) signing another message, which
    forces the classic tail. Verdicts, the recovered bytes against the
    host ``tbls.recover`` of the good partials, meter deltas and exact
    launch counts are checked per run."""
    from drand_tpu_torch import metrics
    from drand_tpu_torch.chain import beacon as cb
    from drand_tpu_torch.crypto import bls, tbls
    from drand_tpu_torch.crypto.poly import PriPoly

    eng = state["engine"]
    poly = PriPoly.random(t, seed=tag)
    msg = cb.message_v2(round_no)
    t0 = time.perf_counter()
    good = _partials(poly, n, msg)
    corrupt = list(good)
    corrupt[bad] = tbls.sign_partial(poly.eval(bad), b"other message")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    expect_sig = tbls.recover(poly.commit(), msg, good, t, n)
    host_recover_s = time.perf_counter() - t0
    if expect_sig != bls.sign(poly.secret(), msg):
        raise RuntimeError("host recovery differs from the group signature")
    shape = eng.agg_shape(n, t)
    if (shape[0] != LIVE_BUCKET or shape[1:] not in state["msm_shapes"]
            or (t, eng._eval_bucket(n)) not in state["fused_horner_shapes"]):
        raise RuntimeError(
            f"round shape {shape} (Horner {t} x {eng._eval_bucket(n)}): "
            f"kernels checked at {LIVE_BUCKET}, {state['msm_shapes']}, "
            f"{state['fused_horner_shapes']}")
    eng.check_round(n, t)                    # gate launches come first
    one = {"miller_loop": 1, "final_exp_verdict": 1, "msm": 1, "horner": 1}
    tail = {"miller_loop": 2, "final_exp_verdict": 2, "msm": 2, "horner": 1}
    out = {"threshold": t, "partials": n, "generate_seconds": gen_s,
           "host_recover_seconds": host_recover_s,
           "msm_lanes": eng.agg_shape(n, t)[1],
           "msm_bits": eng.agg_shape(n, t)[2]}
    for label, parts, expect, launches_want, meters_want in (
            ("valid", good, [True] * n, one, (1, 2 * (n + 1))),
            ("bad_partial", corrupt, [j != bad for j in range(n)], tail,
             (2, 2 * (n + 1) + 2))):
        pub_poly = poly.commit()             # fresh share-key cache
        for k in eng.stage_seconds:
            eng.stage_seconds[k] = 0.0
        checks0, pairs0 = metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS
        _reset_launches()
        t1 = time.perf_counter()
        oks, sig = eng.aggregate_round(pub_poly, msg, parts, t, n)
        wall = time.perf_counter() - t1
        launches = _launch_counts()
        st = dict(eng.stage_seconds)
        meters = (metrics.N_PRODUCT_CHECKS - checks0,
                  metrics.N_MILLER_PAIRS - pairs0)
        run = {"round_seconds": wall, "launches": launches,
               "host_seconds": {k: st[k] for k in ("hash", "decode", "pack")},
               "device_seconds": st["device"],
               "false_at": [j for j, v in enumerate(oks) if not v],
               "recovered_matches_host": sig == expect_sig,
               "meter_deltas": {"product_checks": meters[0],
                                "miller_pairs": meters[1]}}
        out[label] = run
        if (oks != expect or sig != expect_sig or launches != launches_want
                or meters != meters_want):
            raise RuntimeError(f"{label}: {run}")
    return out


def phase_live_round(state) -> dict:
    return _threshold_rounds(state, GROUP_T, GROUP_N, BAD_PARTIAL,
                             GROUP_TAG, N_ROUNDS + 1)


def phase_threshold_round(state) -> dict:
    out = _threshold_rounds(state, BIG_T, BIG_N, BIG_BAD, BIG_TAG,
                            N_ROUNDS + 2)
    state["threshold_launches"] = out["valid"]["launches"]
    return out


def phase_deal_check(state) -> dict:
    """BASELINE config 4: every dealer's commitment polynomial at this
    node's index, through ``eval_commits`` (one Horner launch), against
    the host ``PubPoly.eval`` of each dealer."""
    eng = state["engine"]
    t0 = time.perf_counter()
    polys = _dealers(state)
    gen_s = time.perf_counter() - t0
    eng._check_eval_bucket(DEAL_T, eng._eval_bucket(DEALERS))  # gate first
    for k in eng.stage_seconds:
        eng.stage_seconds[k] = 0.0
    _reset_launches()
    t1 = time.perf_counter()
    got = eng.eval_commits(polys, DEAL_INDEX)
    wall = time.perf_counter() - t1
    launches = _launch_counts()
    st = dict(eng.stage_seconds)
    t2 = time.perf_counter()
    expect = [p.eval(DEAL_INDEX).value for p in polys]
    host_s = time.perf_counter() - t2
    out = {"dealers": DEALERS, "t": DEAL_T, "index": DEAL_INDEX,
           "generate_seconds": gen_s, "eval_seconds": wall,
           "device_seconds": st["device"], "pack_seconds": st["pack"],
           "host_eval_seconds": host_s, "launches": launches,
           "matches_host": got == expect}
    want = {"miller_loop": 0, "final_exp_verdict": 0, "msm": 0, "horner": 1}
    if got != expect or launches != want:
        raise RuntimeError(f"deal_check: {out}")
    return out


def main() -> int:
    try:
        import torch

        import drand_tpu_torch  # noqa: F401 — fails outside a checkout
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    start = time.perf_counter()
    state = {"device": torch.device("cuda"), "card": nvidia_smi()}
    failed = []
    for name, phase in (("build", phase_build), ("kernels", phase_kernels),
                        ("catchup", phase_catchup),
                        ("live_round", phase_live_round),
                        ("threshold_round", phase_threshold_round),
                        ("deal_check", phase_deal_check)):
        t0 = time.perf_counter()
        try:
            out = phase(state)
            emit({"phase": name, "ok": True,
                  "seconds": time.perf_counter() - t0, **out})
        except Exception as e:  # noqa: BLE001 — report and fail the run
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e)})
            failed.append(name)
            if name in ("build", "kernels"):
                break
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    # launches on each kernel's own main path: the catch-up span for K1
    # and K2, the 67-of-100 round (all partials valid) for the MSM and
    # the Horner
    launches = {**state["main_launches"],
                **{k: state["threshold_launches"][k] for k in ("msm",
                                                               "horner")}}
    emit({"phase": "summary", "script_seconds": time.perf_counter() - start,
          "main_path_launches": launches})
    emit({"kernels": [
        {k: v for k, v in dict(rec, launches=launches[key]).items()
         if k != "fp_products_per_check"}
        for key, rec in state["kernels"].items()]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
