"""Drive the PyTorch/CUDA port (``drand_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``drand_tpu_torch/csrc`` and runs four
phases, printing one JSON line each:

1. ``build``    — nvcc build time, ptxas registers and spills per kernel,
                  the card's name and power limit;
2. ``kernels``  — K1 (Miller loop) and K2 (final exponentiation + verdict)
                  against their plain PyTorch versions on the card, word
                  for word, at the buckets of both paths below (512 and
                  128 lanes, each with its own key from a fixed seed; 8
                  valid and 8 corrupted checks in every 16), with their
                  times and the time bound of their integer work;
3. ``catchup``  — the main path: ``BatchedEngine.verify_beacons`` over
                  1024 rounds of a chained beacon that also carries V2
                  signatures, under one 6-of-10 group key, with one V1 and
                  one V2 signature corrupted (2048 checks, 4096 Miller
                  pairs, four launches of each kernel); host and device
                  time are printed apart;
4. ``live_round`` — ``verify_partials`` for the 10 partials of one round,
                  one of them corrupted.

Then a ``{"kernels": [...]}`` summary line, the card's name and power
limit as nvidia-smi prints them, and, if every phase passed, the last
line ``{"ok": true, "device": {...}}``. Any failed phase, a machine
without CUDA, or a directory without the package makes it exit non-zero
without that line. Imports nothing of JAX or of the JAX package.
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
BAD_V1, BAD_V2 = 137, 801         # beacon indices whose V1 / V2 is corrupted
BAD_PARTIAL = 3                   # share index of the corrupted partial
MAIN_BUCKET = 512                 # the catch-up span's bucket
LIVE_BUCKET = 128                 # the live round's bucket (10 partials)
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

    poly = PriPoly.random(GROUP_T, seed=b"chip-smoke-group")
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

def phase_build(state) -> dict:
    from drand_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()["pairing"]
    kernels = {}
    for mangled, props in info["kernels"].items():
        for short in ("miller_loop_kernel", "final_exp_verdict_kernel"):
            if short in mangled:
                kernels[short] = props
    if set(kernels) != {"miller_loop_kernel", "final_exp_verdict_kernel"}:
        raise RuntimeError(f"ptxas reported {sorted(info['kernels'])}")
    return {"build_seconds": info["build_seconds"],
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


def phase_kernels(state) -> dict:
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

    def bound(products, in_bytes, out_bytes):
        ops_s = products * b * MAD_PER_FP_PRODUCT / INT32_MAD_PER_S
        bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S
        return (max(ops_s, bytes_s) * 1e3,
                "operations" if ops_s >= bytes_s else "bytes")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    k1_bound, k1_by = bound(main["k1_products"], nbytes(xp, yp, q),
                            nbytes(f_k))
    k2_bound, k2_by = bound(main["k2_products"], nbytes(f_k),
                            nbytes(gt_k, ok_k))
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


def phase_catchup(state) -> dict:
    from drand_tpu_torch import metrics
    from drand_tpu_torch.crypto import bls
    from drand_tpu_torch.crypto.poly import PriPoly
    from drand_tpu_torch.ops import pairing as pp
    from drand_tpu_torch.ops.engine import BatchedEngine

    t0 = time.perf_counter()
    workers = max(2, min(8, os.cpu_count() or 2))
    beacons = make_chain(N_ROUNDS, workers)
    secret, _ = _group_secret()
    beacons[BAD_V1].signature = bls.sign(secret, b"not-this-round")
    beacons[BAD_V2].signature_v2 = beacons[BAD_V2 + 1].signature_v2
    gen_s = time.perf_counter() - t0
    group_key = PriPoly.random(GROUP_T, seed=b"chip-smoke-group").commit().commit()

    eng = BatchedEngine(device=state["device"])
    eng.check_bucket(MAIN_BUCKET)              # gate launches come first
    state["engine"] = eng
    for k in eng.stage_seconds:
        eng.stage_seconds[k] = 0.0
    checks0, pairs0 = metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS
    for k in pp.LAUNCHES:
        pp.LAUNCHES[k] = 0
    t1 = time.perf_counter()
    verdicts = eng.verify_beacons(group_key, beacons)
    wall = time.perf_counter() - t1
    launches = dict(pp.LAUNCHES)
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
    expect_launches = {"miller_loop": 4, "final_exp_verdict": 4}
    if bad != [BAD_V1, BAD_V2] or d_checks != 1 or d_pairs != 4 * N_ROUNDS \
            or launches != expect_launches:
        raise RuntimeError(f"catchup: {out}")
    return out


def phase_live_round(state) -> dict:
    from drand_tpu_torch.chain import beacon as cb
    from drand_tpu_torch.crypto import tbls
    from drand_tpu_torch.crypto.poly import PriPoly
    from drand_tpu_torch.ops import pairing as pp

    poly = PriPoly.random(GROUP_T, seed=b"chip-smoke-group")
    pub_poly = poly.commit()
    msg = cb.message_v2(N_ROUNDS + 1)
    partials = [tbls.sign_partial(s, msg) for s in poly.shares(GROUP_N)]
    partials[BAD_PARTIAL] = tbls.sign_partial(poly.eval(BAD_PARTIAL),
                                              b"other message")
    eng = state["engine"]
    if eng._bucket(GROUP_N) != LIVE_BUCKET:
        raise RuntimeError(f"live round bucket {eng._bucket(GROUP_N)}, "
                           f"kernels checked at {LIVE_BUCKET}")
    eng.check_bucket(LIVE_BUCKET)              # gate launches come first
    for k in pp.LAUNCHES:
        pp.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    got = eng.verify_partials(pub_poly, msg, partials)
    verify_s = time.perf_counter() - t0
    expect = [i != BAD_PARTIAL for i in range(GROUP_N)]
    out = {"partials": GROUP_N, "threshold": GROUP_T, "verdicts": got,
           "verify_seconds": verify_s, "launches": dict(pp.LAUNCHES)}
    if got != expect or pp.LAUNCHES != {"miller_loop": 1,
                                        "final_exp_verdict": 1}:
        raise RuntimeError(f"live_round: {out}")
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
    state = {"device": torch.device("cuda"), "card": nvidia_smi()}
    failed = []
    for name, phase in (("build", phase_build), ("kernels", phase_kernels),
                        ("catchup", phase_catchup),
                        ("live_round", phase_live_round)):
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
    launches = state["main_launches"]
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
