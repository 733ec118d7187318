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
                   verdict) at 512, 128, 5 (a block's second warp
                   without a check) and 4 lanes; the G2 MSM with GLS4
                   digit scalars at 512 lanes and with 255-bit scalars at
                   128 lanes (its own point and scalar on every lane,
                   lanes alike so that the folds double, masked lanes),
                   at the 6-of-10 round's 32 lanes, at the wire-RLC
                   combine's two sums of 512 lanes × 128 bits in one
                   stacked call (also against one call per sum), at n =
                   1, 3, 5 and 33, on a warp whose lanes' bits differ at
                   every step, with a zero scalar, with equal points in
                   one warp and two equal blocks, and all masked; the G1
                   Horner at 128 lanes, t = 65, per-lane 11-bit indices,
                   in both output forms, and in the fused round's form
                   (Z = 1) on the inputs of the 67-of-100 and 6-of-10
                   rounds; K5 (hash to G2) and K6 (signature
                   decompression) at 512 lanes: the u-values of 500
                   messages of the chain, one warp of K5 checks whose
                   maps take different branches (u = 0 first) and random
                   field elements, K5 also launched alone at 1, 3, 4 and
                   128 lanes and on that warp; 500 signatures of the
                   chain, two of them (both sort flags) in one warp of K6
                   checks with x off the curve, points of E2 outside G2
                   and rows the byte split rejects, and more of those, K6
                   also launched alone at 1, 3, 4 and 128 lanes and on
                   that warp; 22 lanes of K6 and 16 of K5 also against
                   the host;
3. ``probes``    — the card's own probes (``drand_tpu_torch/tools``), each
                   tool's run its main path: ``microbench`` (CUDA-core
                   chains in int32, f32, bf16 and the wide multiply-add
                   pair; mma.sync chains in bf16, int8 and TF32; at the
                   JAX tool's shapes and at shapes that fill the card; the
                   SASS instruction each loop keeps), ``proto_mxu`` (the
                   Montgomery chain on the CUDA cores and with REDC on
                   the int8 tensor cores, B = 128 and a lane count that
                   fills the card) and ``proto_miller_grid`` (63 step
                   launches against K1 at B = 128 and 512); every kernel
                   against its plain version (the integer chains, both
                   REDC chains and the Miller step word for word, the
                   Miller step also against K1 on the kernels phase's
                   512 lanes; the float CUDA-core chains, and the float
                   tensor-core chains over 1 and 8 steps, within the
                   tolerances of ``tools/microbench.py``, and those on a
                   scaled signed permutation word for word), a chain of
                   one PyTorch call a step beside each chain where there
                   is one;
4. ``catchup``   — ``BatchedEngine(wire_prep=False).verify_beacons`` over
                   the first 256 rounds of a chained beacon that also
                   carries V2 signatures, under one 6-of-10 group key,
                   with one V1 and one V2 signature corrupted: host
                   hashing and decoding, one launch of K1 and K2;
5. ``catchup_wire`` — the default engine (the wire path) over the whole
                   1024-round chain: first clean (the wire-RLC tier, one
                   combined product check), then with one V1 and one V2
                   signature corrupted (the combined check fails and the
                   per-item wire path decides);
6. ``live_round`` — the League of Entropy round (6 of 10) through
                   ``aggregate_round``, once with every partial valid and
                   once with one chosen partial signing another message
                   (the classic tail), each on a fresh ``PubPoly``;
7. ``threshold_round`` — the same at 67 of 100 (BASELINE config 3);
8. ``deal_check`` — ``eval_commits`` of 128 dealers' t = 65 commitment
                   polynomials at one node index (BASELINE config 4).

The beacon chain the paths verify is signed in worker processes that
start before the build and run beside it. Each path's launches are
counted from zero just before it runs, after the engine's known-answer
gates, and checked exactly. Then a ``summary``
line, a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and, if every phase passed, the last line
``{"ok": true, "device": {...}}``. Any failed phase, a machine without
CUDA, or a directory without the package makes it exit non-zero without
that line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import subprocess
import sys
import threading
import time
import traceback

SEED = 20260
N_ROUNDS = 1024                   # the wire span
CATCHUP_ROUNDS = 256              # the host-prep span (first rounds)
HOST_BAD_V2 = 201                 # its corrupted V2 (BAD_V1 lies in it too)
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
WIRE_LANES = 512                  # K5 / K6 lanes: the wire span's bucket
RLC_BITS = 128                    # the wire-RLC scalars
COMBINED_BUCKET = 4               # the bucket of the combined row
RAGGED_BUCKET = 5                 # K1/K2: not a multiple of a block's checks
HOST_LANES = 16                   # lanes of K5 / K6 checked on the host
EDGE_LANES = 12                   # K5: u = 0 and random u; K6: x off the
                                  # curve, outside G2, rejected rows
SPAN_LANES = WIRE_LANES - EDGE_LANES   # lanes from the chain
HORNER_LANES = 128
EVAL_BITS = 11
TIMED_LAUNCHES = 5
GENERATE_TIMEOUT_S = 400
CHAIN_WORKERS = 4                 # 1 V1 chain + 3 V2 slices, beside 6 nvcc

# H100 SXM integer rate for the bound: 64 INT32 lanes per SM (Hopper white
# paper) x 132 SMs x 1.98 GHz boost (the clock behind the 67 TFLOP/s
# float32 peak of the H100 SXM data sheet). One 32x32->64 multiply-
# add is counted as two int32 multiply-adds (low and high word).
INT32_MAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
MAD_PER_FP_PRODUCT = 2 * 288 + 12   # CIOS: 144 product + 144 reduction
                                    # wide MADs, 12 m = t0·n0 multiplies
# Peak rates of the H100 SXM for the probes' bounds, dense: FFMA 67
# TFLOP/s, tensor cores 989 (bf16), 1,979 (int8) and 495 (TF32) T/s (the
# data sheet); bf16 outside the tensor cores (HFMA2) 133.8 TFLOP/s (the
# Hopper white paper).
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 133.8e12
TENSOR_OPS_PER_S = {"bf16_f32": 989e12, "int8_i32": 1979e12,
                    "tf32_f32": 495e12}
PROBE_REPS = 5
MAD_PER_PRODUCT_ON_CORES = 2 * 144  # a·b of the tensor-core REDC chain
TENSOR_OPS_PER_REDC = 2 * (48 + 96) * 48   # its two byte GEMMs, per lane


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# data generation (signing workers: subprocesses of this module)
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


def _sign_job(job: dict) -> list:
    """The signatures of one worker's job, as hex strings."""
    if job["kind"] == "v1":
        return [[p.hex(), s.hex()] for p, s in _sign_v1_chain(job["n"])]
    return [s.hex() for s in _sign_v2(job["rounds"])]


_WORKER_CODE = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; "
                "json.dump(chip_smoke._sign_job(json.loads(sys.argv[2])), "
                "sys.stdout)")


def _run_workers(jobs: list[dict]) -> list:
    """Run each job in its own Python process, all started together, and
    return their results in order. Every process is waited for; on a
    failure or at the time limit the ones still running are killed first."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for job in jobs:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER_CODE, here, json.dumps(job)],
                stdout=subprocess.PIPE, text=True))
        deadline = time.monotonic() + GENERATE_TIMEOUT_S
        out = []
        for job, proc in zip(jobs, procs):
            text, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if proc.returncode != 0:
                raise RuntimeError(f"signing worker {job['kind']} exited "
                                   f"with {proc.returncode}")
            out.append(json.loads(text))
        return out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def make_chain(n_rounds: int, workers: int):
    """1024 beacons signed with the group secret (the recovered group
    signature of every round): the V1 chain in one worker, the V2
    signatures spread over the others."""
    from drand_tpu_torch.chain.beacon import Beacon

    rounds = list(range(1, n_rounds + 1))
    n_v2 = max(1, workers - 1)
    chunks = [rounds[i::n_v2] for i in range(n_v2)]
    v1, *v2 = _run_workers([{"kind": "v1", "n": n_rounds}]
                           + [{"kind": "v2", "rounds": c} for c in chunks])
    v2_sigs = {}
    for c, sigs in zip(chunks, v2):
        v2_sigs.update(zip(c, sigs))
    return [Beacon(round=r, previous_sig=bytes.fromhex(v1[r - 1][0]),
                   signature=bytes.fromhex(v1[r - 1][1]),
                   signature_v2=bytes.fromhex(v2_sigs[r]))
            for r in rounds]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

KERNEL_NAMES = {"pairing": ("miller_loop_kernel", "final_exp_verdict_kernel",
                            "miller_step_kernel"),
                "msm": ("msm_ladder_fold_kernel", "msm_final_kernel"),
                "eval": ("eval_horner_kernel",),
                "h2c": ("hash_to_g2_kernel", "decompress_g2_kernel"),
                "microbench": ("chain_i32_kernel", "chain_f32_kernel",
                               "chain_bf16_kernel", "chain_wide_kernel",
                               "mma_bf16_kernel", "mma_s8_kernel",
                               "mma_tf32_kernel"),
                "mxu_redc": ("mont_chain_cuda_kernel", "mont_chain_tc_kernel")}


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
    state["ptxas"] = kernels
    # the out-of-line slot operations of K5, K6 and the MSM (csrc/
    # g2_group.cuh gg_*, h2c.cu k6_*) and of K1 and K2 (csrc/f12_group.cuh
    # fo_*): their frames are not in the kernels' own ptxas lines
    state["group_callees"] = {
        lib: {f: v for f, v in infos[lib]["functions"].items()
              if "gg_" in f or "k6_" in f or "fo_" in f}
        for lib in ("h2c", "msm", "pairing")}
    return {"build_seconds": {k: v["build_seconds"] for k, v in infos.items()},
            "wall_seconds": time.perf_counter() - t0,
            "ptxas": kernels, "group_callees": state["group_callees"],
            "card": state["card"]}


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


def _against_plain(pp, field, xp, yp, q) -> dict:
    """K1 and K2 on (xp, yp, q), and their plain versions on the same
    inputs; the errors, outputs, plain times and Fp products per check."""
    import torch

    from drand_tpu_torch.tools._common import max_abs_err, time_once

    b = xp.shape[0]
    f_k = pp.miller_loop(xp, yp, q)
    field.N_FP_PRODUCTS = 0
    f_p, k1_plain_ms = time_once(lambda: pp.miller_loop_plain(xp, yp, q))
    k1_products = field.N_FP_PRODUCTS / b
    gt_k, ok_k = pp.final_exp_verdict(f_k)
    field.N_FP_PRODUCTS = 0
    (gt_p, ok_p), k2_plain_ms = time_once(lambda: pp.final_exp_plain(f_k))
    k2_products = field.N_FP_PRODUCTS / b
    torch.cuda.synchronize()
    return {"k1_err": max_abs_err(f_k, f_p),
            "k2_err": max(max_abs_err(gt_k, gt_p), max_abs_err(ok_k, ok_p)),
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
    """K1 and K2 against their plain versions at the buckets of the
    paths: MAIN_BUCKET (the catch-up span), LIVE_BUCKET (the live round),
    COMBINED_BUCKET (the combined row) and RAGGED_BUCKET (a block's last
    warp without a check), every lane with its own inputs."""
    from drand_tpu_torch.ops import field, pairing as pp
    from drand_tpu_torch.ops.limb import unpack_ints
    from drand_tpu_torch.tools._common import time_ms

    dev = state["device"]
    (pubs, sigs, msgs), expect, oracle = _kernel_inputs(dev, MAIN_BUCKET)
    xp, yp, q = pp.pack_verify_inputs(pubs, sigs, msgs)
    b = xp.shape[0]
    main = _against_plain(pp, field, xp, yp, q)
    xl, yl, ql = xp[:LIVE_BUCKET], yp[:LIVE_BUCKET], q[:LIVE_BUCKET]
    live = _against_plain(pp, field, xl, yl, ql)
    xc, yc, qc = (t[:COMBINED_BUCKET].contiguous() for t in (xp, yp, q))
    comb = _against_plain(pp, field, xc, yc, qc)
    xr, yr, qr = (t[:RAGGED_BUCKET].contiguous() for t in (xp, yp, q))
    ragged = _against_plain(pp, field, xr, yr, qr)
    f_k, gt_k, ok_k = main["f"], main["gt"], main["ok"]
    # the Miller step kernel is held against K1 on these lanes (probes)
    state["k1_main"] = (xp, yp, q, f_k)

    verdicts_ok = (ok_k.cpu().tolist() == expect
                   and live["ok"].cpu().tolist() == expect[:LIVE_BUCKET]
                   and comb["ok"].cpu().tolist() == expect[:COMBINED_BUCKET]
                   and ragged["ok"].cpu().tolist() == expect[:RAGGED_BUCKET])
    oracle_ok = all(unpack_ints(gt[8]).reshape(-1).tolist() == oracle
                    for gt in (gt_k, live["gt"]))
    k1_ms = time_ms(lambda: pp.miller_loop(xp, yp, q), TIMED_LAUNCHES)
    k2_ms = time_ms(lambda: pp.final_exp_verdict(f_k), TIMED_LAUNCHES)
    k1_live_ms = time_ms(lambda: pp.miller_loop(xl, yl, ql), TIMED_LAUNCHES)
    k2_live_ms = time_ms(lambda: pp.final_exp_verdict(live["f"]),
                         TIMED_LAUNCHES)
    k1_comb_ms = time_ms(lambda: pp.miller_loop(xc, yc, qc), TIMED_LAUNCHES)
    k2_comb_ms = time_ms(lambda: pp.final_exp_verdict(comb["f"]),
                         TIMED_LAUNCHES)
    k1_ragged_ms = time_ms(lambda: pp.miller_loop(xr, yr, qr), TIMED_LAUNCHES)
    k2_ragged_ms = time_ms(lambda: pp.final_exp_verdict(ragged["f"]),
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
            "max_abs_err": max(main["k1_err"], live["k1_err"],
                               comb["k1_err"], ragged["k1_err"]),
            "ms": k1_ms, "plain_ms": main["k1_plain_ms"],
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
            "fp_products_per_check": main["k1_products"]},
        "final_exp_verdict": {
            "name": "final_exp_verdict_kernel", "route": "cuda",
            "source": "drand_tpu_torch/csrc/pairing.cu",
            "replaces": "drand_tpu/ops/pallas_pairing.py:376",
            "max_abs_err": max(main["k2_err"], live["k2_err"],
                               comb["k2_err"], ragged["k2_err"]),
            "ms": k2_ms, "plain_ms": main["k2_plain_ms"],
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
            "fp_products_per_check": main["k2_products"]},
    }
    for key in state["kernels"]:
        ptx = state["ptxas"][state["kernels"][key]["name"]]
        state["kernels"][key].update(
            registers=ptx["registers"], stack_bytes=ptx["stack_bytes"],
            callee_stack_bytes=_callee_stack("pairing", state))
    errs = {f"{k}_at_{n}": r[k] for n, r in ((b, main), (LIVE_BUCKET, live),
                                             (COMBINED_BUCKET, comb),
                                             (RAGGED_BUCKET, ragged))
            for k in ("k1_err", "k2_err")}
    if any(errs.values()) or not verdicts_ok or not oracle_ok:
        raise RuntimeError(f"kernel mismatch: {errs}, verdicts ok "
                           f"{verdicts_ok}, host oracle GT ok {oracle_ok}")
    live_ms = {"miller_loop": (k1_live_ms, live["k1_plain_ms"]),
               "final_exp_verdict": (k2_live_ms, live["k2_plain_ms"])}
    comb_ms = {"miller_loop": (k1_comb_ms, comb["k1_plain_ms"]),
               "final_exp_verdict": (k2_comb_ms, comb["k2_plain_ms"])}
    ragged_ms = {"miller_loop": k1_ragged_ms,
                 "final_exp_verdict": k2_ragged_ms}
    return {"batch": b, "live_batch": LIVE_BUCKET,
            "combined_batch": COMBINED_BUCKET,
            "ragged_batch": RAGGED_BUCKET, "tolerance": 0,
            "errors": errs, "launches": dict(pp.LAUNCHES),
            "verdicts_match_expected": verdicts_ok,
            "gt_matches_host_oracle": oracle_ok,
            "kernels": [{"name": k["name"], "match": k["max_abs_err"] == 0,
                         "launches": pp.LAUNCHES[key],
                         "ms_at_512": k["ms"], "plain_ms_at_512": k["plain_ms"],
                         "ms_at_128": live_ms[key][0],
                         "plain_ms_at_128": live_ms[key][1],
                         "ms_at_4": comb_ms[key][0],
                         "plain_ms_at_4": comb_ms[key][1],
                         "ms_at_5": ragged_ms[key],
                         "registers": k["registers"],
                         "stack_bytes": k["stack_bytes"],
                         "callee_stack_bytes": k["callee_stack_bytes"],
                         "bound_ms": k["bound_ms"],
                         "fp_products_per_check": k["fp_products_per_check"]}
                        for key, k in state["kernels"].items()]}


def _launch_counts() -> dict:
    from drand_tpu_torch.ops import eval as ev, msm, pairing as pp, wire

    return {**pp.LAUNCHES, **msm.LAUNCHES, **ev.LAUNCHES, **wire.LAUNCHES}


def _launches(**counts) -> dict:
    """Expected launch counts: every kernel, 0 unless given."""
    return {k: counts.get(k, 0) for k in _launch_counts()}


def _reset_launches() -> None:
    from drand_tpu_torch.ops import eval as ev, msm, pairing as pp, wire

    for counts in (pp.LAUNCHES, msm.LAUNCHES, ev.LAUNCHES, wire.LAUNCHES):
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
    a = pts[0][0]
    sqr = _products(lambda: field.f2_sqr(a))
    mul = _products(lambda: field.f2_mul(a, a))
    # a Jacobian point plus an affine one (EFD madd-2007-bl, a = 0): Z1²,
    # H², r², (Z1 + H)² and X2·Z1², Z1·Z1², Y2·Z1³, H·I, X1·I, r·(V − X3),
    # Y1·J
    out["g2_madd"] = 4 * sqr + 7 * mul
    return out


def _ladder_products(k: int, dbl: int, add: int) -> int:
    """Fp products a double-and-add over k needs from its top bit."""
    return 0 if k == 0 else ((k.bit_length() - 1) * dbl
                             + (bin(k).count("1") - 1) * add)


def _msm_needed_products(live: list, counts: dict) -> dict:
    """Fp products that one sum of Σ sᵢ·Pᵢ over affine Pᵢ with the live
    lanes' scalars ``live`` needs, for the MSM's bound: a bucket
    (Pippenger) MSM at the cheapest window c of 1-12 bits, counted on
    this run's scalars. In each window of c bits from the top bit of the
    largest scalar, every point with a nonzero digit goes into its
    digit's bucket (the first point of a bucket is a copy, each further
    one a mixed addition, ``g2_madd``); the buckets are summed by running
    sums from the top bucket (an addition where both sides hold a point:
    mixed where the bucket holds one point, else complete); the windows
    are joined by c doublings and one addition each; then one to-affine.
    Unsigned digits: signed ones or batched affine additions would need
    fewer."""
    top = max(live, default=0).bit_length()
    if top == 0:
        return {"window": 0, "products": 0}
    best = None
    for c in range(1, 13):
        n_madd = n_add = n_dbl = 0
        windows = -(-top // c)
        for w in range(windows):
            fill = {}
            for sc in live:
                d = (sc >> (c * w)) & ((1 << c) - 1)
                if d:
                    fill[d] = fill.get(d, 0) + 1
            n_madd += sum(fill.values()) - len(fill)
            run = tot = False
            for d in range(2 ** c - 1, 0, -1):
                if d in fill:
                    if run:
                        n_madd += fill[d] == 1
                        n_add += fill[d] > 1
                    run = True
                if run:
                    n_add += tot
                    tot = True
            if w < windows - 1:
                n_dbl += c
                n_add += tot
        cost = (n_madd * counts["g2_madd"] + n_add * counts["g2_add"]
                + n_dbl * counts["g2_dbl"] + counts["g2_aff"])
        if best is None or cost < best["products"]:
            best = {"window": c, "products": cost}
    return best


def _msm_case(dev, rng, n_lanes: int, nbits: int, counts: dict, k: int = 1,
              equal=None, masked=None, scalars=None) -> dict:
    """One MSM input from SEED: k sums over the same mask and bits, every
    lane of every sum its own point and scalar. By default lanes 1, 16
    and n/2 equal lane 0, point and scalar (so that the kernel's warp
    fold and the plain fold both take the doubling case), and every 7th
    lane and the last are masked; ``equal`` ((dst, src) lane pairs),
    ``masked`` (a 0/1 list) and ``scalars`` replace those. Kernel against
    plain word for word, a stacked call (k > 1) also against k calls of
    one sum, and every sum against the host's Σ s·P."""
    import numpy as np
    import torch

    from drand_tpu_torch.crypto.curves import PointG2
    from drand_tpu_torch.crypto.fields import R
    from drand_tpu_torch.ops import msm
    from drand_tpu_torch.ops.curve import scalar_to_bits
    from drand_tpu_torch.ops.engine import _g2_from_words, _g2_xy
    from drand_tpu_torch.tools._common import max_abs_err, time_ms, time_once

    g = PointG2.generator()
    sums = []
    for _ in range(k):
        step, p = g.mul(rng.randrange(1, R)), g.mul(rng.randrange(1, R))
        pts = []
        for _ in range(n_lanes):
            pts.append(p)
            p = p + step
        sums.append(pts)
    top = R if nbits >= 255 else 1 << nbits
    scal = scalars or [rng.randrange(1, top) for _ in range(n_lanes)]
    if equal is None:
        equal = [(j, 0) for j in sorted({1, 16, n_lanes // 2}) if
                 0 < j < n_lanes - 1]
    for dst, src in equal:
        scal[dst] = scal[src]
        for pts in sums:
            pts[dst] = pts[src]
    mask = masked or [int(i % 7 == 3 or i == n_lanes - 1)
                      for i in range(n_lanes)]
    arr = np.stack([np.stack([_g2_xy(xy) for xy in
                              PointG2.batch_to_affine(pts)]) for pts in sums])
    bits = np.stack([scalar_to_bits(c, nbits) for c in scal])
    args = [torch.from_numpy(a).to(dev) for a in
            (arr if k > 1 else arr[0], np.array(mask, np.int32),
             bits.astype(np.int32))]
    xy_k, inf_k = msm.msm(*args)
    (xy_p, inf_p), plain_ms = time_once(lambda: msm.msm_plain(*args))
    err = max(max_abs_err(xy_k, xy_p), max_abs_err(inf_k, inf_p))
    if k > 1:          # the stacked call equals one call per sum
        for j in range(k):
            xy_j, inf_j = msm.msm(args[0][j].contiguous(), *args[1:])
            err = max(err, max_abs_err(xy_j, xy_k[j]),
                      max_abs_err(inf_j, inf_k[j]))
    xy_h = xy_k.reshape(k, 2, 2, -1).cpu().numpy()
    inf_h = inf_k.reshape(k).cpu().tolist()
    host_ok = True
    for j, pts in enumerate(sums):
        host = PointG2.infinity()
        for pt, c, m in zip(pts, scal, mask):
            if not m:
                host = host + pt.mul(c)
        host_ok &= (bool(inf_h[j]) == host.is_infinity() and (
            inf_h[j] or _g2_from_words(xy_h[j]) == host))
    live = [c for c, m in zip(scal, mask) if not m]
    needed = _msm_needed_products(live, counts)
    ladder = k * (sum(_ladder_products(c, counts["g2_dbl"],
                                       counts["g2_add"]) for c in live)
                  + max(len(live) - 1, 0) * counts["g2_add"]
                  + counts["g2_aff"])
    products = k * needed["products"]
    bound, by = _bound_ms(products, _nbytes(*args, xy_k, inf_k))
    ms = time_ms(lambda: msm.msm(*args), TIMED_LAUNCHES)
    return {"lanes": n_lanes, "nbits": nbits, "sums": k,
            "masked": sum(mask), "max_abs_err": err,
            "host_match": bool(host_ok), "infinity": inf_h,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "share_of_bound": bound / ms,
            "fp_products_needed": products, "bucket_window": needed["window"],
            "fp_products_ladders": ladder}


def _msm_edge_cases(dev, rng, counts: dict) -> dict:
    """The MSM's edge cases, each word for word against its plain version
    and against the host: n = 1, 3, 5 and 33 (partly filled warps and
    blocks; a warp is eight lanes); one warp whose lanes' bits differ at
    every step (lane j's bit i is (i + j) mod 2); a lane with scalar 0;
    equal points inside one warp (lanes 0 and 1) and two equal blocks
    (lanes 8-15 repeat 0-7), so that the warp fold and the fold of the
    block partials both take the doubling case; every lane masked."""
    nb = 16
    out = {f"n{n}": _msm_case(dev, rng, n, 64, counts, masked=[0] * n,
                              equal=[] if n < 3 else [(1, 0)])
           for n in (1, 3, 5, 33)}
    alt = [int("".join(str((i + j) % 2) for i in range(nb)), 2)
           for j in range(8)]
    out["bits_differ"] = _msm_case(dev, rng, 8, nb, counts, masked=[0] * 8,
                                   equal=[], scalars=alt)
    zero = [rng.randrange(1, 1 << nb) for _ in range(8)]
    zero[5] = 0
    out["zero_scalar"] = _msm_case(dev, rng, 8, nb, counts, masked=[0] * 8,
                                   equal=[], scalars=zero)
    out["equal_blocks"] = _msm_case(
        dev, rng, 16, nb, counts, masked=[0] * 16,
        equal=[(1, 0)] + [(8 + j, j) for j in range(8)])
    out["all_masked"] = _msm_case(dev, rng, 32, 64, counts, masked=[1] * 32,
                                  equal=[])
    if out["all_masked"]["infinity"] != [1]:
        raise RuntimeError(f"all-masked MSM is not infinity: {out}")
    return out


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
    from drand_tpu_torch.tools._common import max_abs_err, time_ms, time_once

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
        (xyz_p, inf_p), plain_ms = time_once(
            lambda: ev.horner_plain(com_d, bits_d, affine))
        errs[f"affine_{affine}"] = max(max_abs_err(xyz_k, xyz_p),
                                       max_abs_err(inf_k, inf_p))
        got = BatchedEngine._unpack_eval_host(
            xyz_k.cpu().numpy(), inf_k.cpu().numpy(), 8)
        out[f"host_match_affine_{affine}"] = got == [
            p.eval(i).value for p, i in zip(polys[:8], idx[:8])]
        out[f"ms_affine_{affine}"] = time_ms(
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
    from drand_tpu_torch.tools._common import max_abs_err, time_ms, time_once

    eng = BatchedEngine(device=dev)
    poly = PriPoly.random(t, seed=tag).commit()
    b = eng._eval_bucket(n)
    com_d = eng._poly_commit_words(poly, b)
    bits_d = eng._index_bits(list(range(n)), b)
    xyz_k, inf_k = ev.horner(com_d, bits_d, True)
    (xyz_p, inf_p), plain_ms = time_once(
        lambda: ev.horner_plain(com_d, bits_d, True))
    err = max(max_abs_err(xyz_k, xyz_p), max_abs_err(inf_k, inf_p))
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
            "ms": time_ms(lambda: ev.horner(com_d, bits_d, True),
                          TIMED_LAUNCHES),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "fp_products": products}


def _curve_kernels(state) -> dict:
    """The MSM and Horner kernels against their plain versions at the
    shapes of their launches: the MSM with GLS4 digits at 512 lanes (67
    of 100) and 32 lanes (6 of 10), 255-bit scalars at 128 lanes, the
    wire-RLC combine's two sums of 512 lanes × 128 bits in one stacked
    call, and its edge cases (``_msm_edge_cases``); the Horner at t = 65
    with per-lane indices in both output forms, and in the fused form on
    both rounds' inputs. The kernels line reports each kernel at the
    shape and form of its launches on the 67-of-100 round, and the MSM
    also at the wire-RLC combine's launch."""
    from drand_tpu_torch.ops.engine import msm_lanes

    dev = state["device"]
    rng = random.Random(SEED + 1)
    counts = _point_products()
    gls4 = _msm_case(dev, rng, MSM_GLS4_LANES, 64, counts)
    full = _msm_case(dev, rng, MSM_FULL_LANES, 255, counts)
    live = _msm_case(dev, rng, msm_lanes(GROUP_T, True), 64, counts)
    rlc = _msm_case(dev, rng, WIRE_LANES, RLC_BITS, counts, k=2)
    edges = _msm_edge_cases(dev, rng, counts)
    horner = _horner_case(state, rng, counts)
    h_big = _horner_round_case(dev, BIG_T, BIG_N, BIG_TAG, counts)
    h_live = _horner_round_case(dev, GROUP_T, GROUP_N, GROUP_TAG, counts)
    msm_cases = (gls4, full, live, rlc, *edges.values())
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
        "library_ms": None, "share_of_bound": gls4["share_of_bound"],
        "shape": "GLS4, 512 lanes x 64 bits"}
    # the same kernels at the wire-RLC combine's launch: both sums of a
    # bucket in one launch
    state["kernels"]["msm_wire_rlc"] = dict(
        state["kernels"]["msm"], ms=rlc["ms"], plain_ms=rlc["plain_ms"],
        bound_ms=rlc["bound_ms"], bound_by=rlc["bound_by"],
        share_of_bound=rlc["share_of_bound"],
        shape=f"2 sums x {WIRE_LANES} lanes x {RLC_BITS} bits")
    ptx = [state["ptxas"][f"msm_{part}_kernel"] for part in ("ladder_fold",
                                                            "final")]
    for key in ("msm", "msm_wire_rlc"):
        state["kernels"][key].update(
            registers=[p["registers"] for p in ptx],
            stack_bytes=max(p["stack_bytes"] for p in ptx),
            callee_stack_bytes=_callee_stack("msm", state))
    state["kernels"]["horner"] = {
        "name": "eval_horner_kernel", "route": "cuda",
        "source": "drand_tpu_torch/csrc/eval.cu",
        "replaces": "drand_tpu/ops/pallas_eval.py:73",
        "max_abs_err": max(c["max_abs_err"] for c in horner_cases),
        "ms": h_big["ms"], "plain_ms": h_big["plain_ms"],
        "bound_ms": h_big["bound_ms"], "bound_by": h_big["bound_by"],
        "library_ms": None}
    out = {"tolerance": 0, "msm_gls4": gls4, "msm_full": full,
           "msm_live_round": live, "msm_wire_rlc": rlc, "msm_edges": edges,
           "horner": horner, "horner_round_67_of_100": h_big,
           "horner_round_6_of_10": h_live, "point_products": counts}
    bad = (state["kernels"]["msm"]["max_abs_err"]
           or state["kernels"]["horner"]["max_abs_err"]
           or not all(c["host_match"] for c in (*msm_cases, h_big, h_live))
           or not all(horner[f"host_match_affine_{a}"] for a in (False, True)))
    if bad:
        raise RuntimeError(f"curve kernel mismatch: {out}")
    return out


def _start_chain(state) -> None:
    """Sign the clean N_ROUNDS-round chain in a thread, started before the
    build so that the signing workers (the V1 chain is one worker's ~65 s)
    run while nvcc and the first kernel checks do; ``_chain`` waits."""
    def sign():
        t0 = time.perf_counter()
        try:
            state["chain"] = make_chain(N_ROUNDS, CHAIN_WORKERS)
        except Exception as e:  # noqa: BLE001 — raised by _chain
            state["chain_error"] = e
        state["chain_seconds"] = time.perf_counter() - t0

    state["chain_thread"] = threading.Thread(target=sign)
    state["chain_thread"].start()


def _chain(state):
    """The clean chain, made once for every phase (``_start_chain``)."""
    state["chain_thread"].join()
    if "chain_error" in state:
        raise RuntimeError("signing the chain failed") \
            from state["chain_error"]
    return state["chain"]


def _corrupt(beacons, bad_v1: int, bad_v2: int):
    """Copies of ``beacons``: V1 of ``bad_v1`` signs another message, V2 of
    ``bad_v2`` is the next round's."""
    from drand_tpu_torch.crypto import bls

    secret, _ = _group_secret()
    out = [dataclasses.replace(b) for b in beacons]
    out[bad_v1].signature = bls.sign(secret, b"not-this-round")
    out[bad_v2].signature_v2 = beacons[bad_v2 + 1].signature_v2
    return out


def _f2_of(w):
    from drand_tpu_torch.crypto.fields import Fp2
    from drand_tpu_torch.ops.limb import fp_from_words

    return Fp2(fp_from_words(w[0]), fp_from_words(w[1]))


def _products(fn) -> float:
    """Fp products of one plain call, counted by ops/field.py."""
    from drand_tpu_torch.ops import field

    field.N_FP_PRODUCTS = 0
    fn()
    return field.N_FP_PRODUCTS


def _f2_pow_products(e: int, sqr: float, mul: float) -> float:
    """Fp products of a^e in Fp2 by the cheapest sliding window (widths
    1-6): the table a^2 and the odd powers up to a^(2^w - 1), then one
    squaring per exponent bit after the leading window and one product
    per further window."""
    bits = bin(e)[2:]
    best = None
    for w in range(1, 7):
        n_sqr, n_mul = (1, 2 ** (w - 1) - 1) if w > 1 else (0, 0)
        i, first = 0, True
        while i < len(bits):
            if bits[i] == "0":
                n_sqr, i = n_sqr + 1, i + 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            if not first:
                n_sqr, n_mul = n_sqr + j - i, n_mul + 1
            first, i = False, j
        cost = n_sqr * sqr + n_mul * mul
        best = cost if best is None else min(best, cost)
    return best


def _hash_to_g2_needed_products(u) -> dict:
    """Fp products per lane that hash-to-G2 needs, for K5's bound: two
    maps by RFC 9380's inversion-free simplified SWU (F.2) with one
    sqrt_ratio (F.2.1.1, p² ≡ 9 mod 16: c1 = 3) — one exponentiation by
    (p² − 9)/16 per map — then the 3-isogeny from the projective x = N/D
    to a Jacobian point, the sum of the two maps, Budroni-Pintore clearing
    and the final to-affine. Fp2 squarings and products are priced as
    ``ops/field`` computes them; products by the small constants A' =
    240i, B' = 1012(1+i) and Z = −(2+i) are additions and cost none. The
    sum, clearing and to-affine are the plain versions' own counts on one
    lane (the formulas K5 runs). Every lane needs the same count."""
    from drand_tpu_torch.crypto.fields import P
    from drand_tpu_torch.ops import curve as cv, field, h2c
    from drand_tpu_torch.ops.limb import words_to_halves

    uh = words_to_halves(u[:1])
    a = uh[:, 0]
    sqr = _products(lambda: field.f2_sqr(a))
    mul = _products(lambda: field.f2_mul(a, a))
    # SSWU straight line: u², (Zu²)², tv3², tv4² and x = tv1·tv3, y =
    # tv1·u·y1, tv2·tv3, tv6·tv4; sgn0 of u and y: one from-Montgomery
    # product each
    sswu = 4 * sqr + 5 * mul + 2
    # sqrt_ratio around its exponentiation: v^7 (2 sqr, 2 mul), tv2²·v,
    # u·tv3, four products after the power, tv4^4, the c7 and c6
    # products, then two rounds of the c1 loop (3 sqr, 4 mul)
    sqrt_ratio = (8 * sqr + 14 * mul
                  + _f2_pow_products((P * P - 9) // 16, sqr, mul))
    # isogeny: e = N − x0·D; X = c2·D·(N·e² + V·e·D² + U·D³), Y = c3·y·D³·
    # (e³ − V·e·D² − 2U·D³), Z = D·e
    iso = 2 * sqr + 13 * mul
    p = h2c.map_to_curve(uh.movedim(1, 0))
    q0, q1 = (tuple(c[k] for c in p) for k in (0, 1))
    add = _products(lambda: cv.pt_add(cv.F2, q0, q1))
    q = cv.pt_add(cv.F2, q0, q1)
    clear = _products(lambda: cv.clear_cofactor(cv.F2, q))
    c = cv.clear_cofactor(cv.F2, q)
    affine = _products(lambda: cv.pt_to_affine(cv.F2, c))
    per_map = sswu + sqrt_ratio + iso
    return {"per_map": per_map, "sqrt_ratio": sqrt_ratio, "add": add,
            "clear_cofactor": clear, "to_affine": affine,
            "per_lane": 2 * per_map + add + clear + affine}


def _first_candidate_square(uk) -> bool:
    """Whether SSWU's first candidate g'(x1) is a square for the host Fp2
    value ``uk`` (x1 = B/(Z·A) where tv = 0): the map then takes no
    second square root."""
    from drand_tpu_torch.crypto.fields import Fp2
    from drand_tpu_torch.crypto.hash_to_curve import (
        _B_OVER_ZA, _MINUS_B_OVER_A, _Z_SSWU, _g_prime)

    zu2 = _Z_SSWU * uk.square()
    tv = zu2.square() + zu2
    x1 = _B_OVER_ZA if tv.is_zero() else \
        _MINUS_B_OVER_A * (Fp2.one() + tv.inverse())
    return _g_prime(x1).is_square()


def _mixed_warp(rng):
    """Four adjacent checks (one warp of K5: 32 threads, eight a check)
    whose maps take different branches: u = 0 in both maps (tv = 0), both
    first candidates squares, neither, and one of each (the two
    half-groups of one check diverge)."""
    import numpy as np

    from drand_tpu_torch.crypto.fields import P, Fp2
    from drand_tpu_torch.ops.limb import fp_words

    sq, nsq = [], []
    while len(sq) < 3 or len(nsq) < 3:
        x = Fp2(rng.randrange(P), rng.randrange(P))
        (sq if _first_candidate_square(x) else nsq).append(x)
    zero = Fp2(0, 0)
    rows = [(zero, zero), (sq[0], sq[1]), (nsq[0], nsq[1]), (sq[2], nsq[2])]
    return np.array([[[fp_words(x.c0), fp_words(x.c1)] for x in row]
                     for row in rows], np.int32)


def _k5_case(state, rng) -> dict:
    """K5 against its plain version on WIRE_LANES lanes — the u-values of
    the first 500 messages of the chain (V1 and V2), one warp of checks
    whose maps take different branches (``_mixed_warp``, its first u = 0:
    tv = 0 in both maps) and random field elements — word for word on
    every lane; K5 launched alone at n = 1, 3, 4 and 128 (partly filled
    warps) and on the mixed warp, word for word against the same plain
    rows; HOST_LANES lanes against the host: ``hash_to_g2`` of the
    message, and the host maps summed and cleared for the u = 0 lane and
    two random ones. The bound counts what hash-to-G2 needs
    (``_hash_to_g2_needed_products``: one exponentiation per map, no
    inversion but the final one). Beside it, the Fp products K5 performs
    on this run's lanes: the plain version's count (it takes every
    branch, both square roots of each map as K5 does) less, in each warp
    of 32 / G checks, the inversion of every map where no map of the warp
    needs it (a warp runs a branch where any of its maps takes it), and
    the count the lanes' own branches need (one root where the first
    candidate is a square, no inversion where tv = 0)."""
    import numpy as np
    import torch

    from drand_tpu_torch.chain import beacon as cb
    from drand_tpu_torch.crypto.fields import P
    from drand_tpu_torch.crypto.hash_to_curve import (
        _H_CLEAR, _Z_SSWU, hash_to_g2, map_to_curve_g2)
    from drand_tpu_torch.ops import field, h2c, wire
    from drand_tpu_torch.ops.engine import _g2_from_words
    from drand_tpu_torch.ops.limb import fp_words, words_to_halves
    from drand_tpu_torch.tools._common import max_abs_err, time_ms, time_once

    dev = state["device"]
    chain = _chain(state)
    msgs = []
    for bcn in chain[:SPAN_LANES // 2]:
        msgs += [cb.message(bcn.round, bcn.previous_sig),
                 cb.message_v2(bcn.round)]
    group = wire.group_size()
    warp = 32 // group
    mixed = _mixed_warp(rng)
    n_rand = WIRE_LANES - len(msgs) - len(mixed)
    rand = np.array([[[fp_words(rng.randrange(P)), fp_words(rng.randrange(P))]
                      for _ in range(2)] for _ in range(n_rand)], np.int32)
    u_np = np.concatenate([h2c.msgs_to_u(msgs), mixed, rand])
    zero = len(msgs)                  # warp-aligned: 500 = 125 warps of 4
    if zero % warp or len(mixed) != warp:
        raise RuntimeError(f"the mixed warp is not one warp at {zero}")
    u = torch.from_numpy(u_np).to(dev)
    xy_k, inf_k = wire.hash_to_g2(u)
    field.N_FP_PRODUCTS = 0
    (xy_p, inf_p), plain_ms = time_once(lambda: h2c.hash_to_g2_plain(u))
    full = field.N_FP_PRODUCTS / WIRE_LANES
    err = max(max_abs_err(xy_k, xy_p), max_abs_err(inf_k, inf_p))
    sizes_err = {}
    for label, lo, hi in (("n1", 0, 1), ("n3", 0, 3), ("n4", 0, 4),
                          ("n128", 0, 128), ("mixed_warp", zero, zero + warp)):
        xy_n, inf_n = wire.hash_to_g2(u[lo:hi].contiguous())
        sizes_err[label] = max(max_abs_err(xy_n, xy_p[lo:hi]),
                               max_abs_err(inf_n, inf_p[lo:hi]))
    lanes = list(range(HOST_LANES - 3)) + [zero, zero + warp - 1,
                                           zero + warp]
    xy_h, inf_h = xy_k.cpu().numpy(), inf_k.cpu().numpy()
    host_ok = True
    for j in lanes:
        if j < len(msgs):
            want = hash_to_g2(msgs[j])
        else:
            us = [_f2_of(u_np[j, k]) for k in range(2)]
            want = (map_to_curve_g2(us[0]) + map_to_curve_g2(us[1])).mul(
                _H_CLEAR)
        got = None if inf_h[j] else _g2_from_words(xy_h[j])
        host_ok &= (got is None) == want.is_infinity() and (
            got is None or got == want)
    # what this run's lanes need and what K5 performs (see the docstring)
    one = words_to_halves(u[:1, 0])
    sqrt_cost = _products(lambda: h2c.sqrt_f2(one))
    inv_cost = _products(lambda: field.f2_inv(one))
    square = np.array([[_first_candidate_square(_f2_of(row[k]))
                        for k in range(2)] for row in u_np])
    zu2 = [[_Z_SSWU * _f2_of(row[k]).square() for k in range(2)]
           for row in u_np]
    tv_zero = np.array([[(z.square() + z).is_zero() for z in row]
                        for row in zu2])
    own = sqrt_cost * square.sum() + inv_cost * tv_zero.sum()
    skipped = sum(tv_zero[w0:w0 + warp].size * inv_cost
                  * tv_zero[w0:w0 + warp].all()
                  for w0 in range(0, WIRE_LANES, warp))
    needed = _hash_to_g2_needed_products(u)
    bound, by = _bound_ms(needed["per_lane"] * WIRE_LANES,
                          _nbytes(u, xy_k, inf_k))
    ms = time_ms(lambda: wire.hash_to_g2(u), TIMED_LAUNCHES)
    u128, umix = u[:128].contiguous(), u[zero:zero + warp].contiguous()
    return {"lanes": WIRE_LANES, "message_lanes": len(msgs),
            "mixed_warp_lanes": len(mixed), "zero_lanes": 1,
            "random_lanes": n_rand, "group": group, "max_abs_err": err,
            "sizes_err": sizes_err,
            "infinity_lanes": int(inf_k.sum().item()),
            "host_lanes": len(lanes), "host_match": bool(host_ok),
            "ms": ms,
            "ms_at_128": time_ms(lambda: wire.hash_to_g2(u128),
                                 TIMED_LAUNCHES),
            "ms_at_4": time_ms(lambda: wire.hash_to_g2(umix),
                               TIMED_LAUNCHES),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms,
            "fp_products_needed_per_lane": needed,
            "fp_products_per_lane_all_branches": full,
            "fp_products_per_lane": full - skipped / WIRE_LANES,
            "fp_products_per_lane_own_branches": full - own / WIRE_LANES}


def _k6_case(state, rng) -> dict:
    """K6 against its plain version on WIRE_LANES lanes — 500 signatures
    of the chain (both sort flags), two of them (one with the sort flag,
    one without) in one warp of K6 checks with x off the curve and points
    of E2 outside G2 (x with x³ + 4(1+u) a square, not cleared), each
    with both flags, and two rows ``sigs_to_x`` rejects (zeros in, zeros
    out), then six more of those — word for word on every lane; K6
    launched alone at n = 1, 3, 4 and 128 and on the mixed warp, word for
    word against the same plain rows; HOST_LANES lanes against the host
    ``decode_sig``. Fp products per lane: the plain count (every lane runs
    the subgroup check) less that check on lanes whose x is not on the
    curve."""
    import numpy as np
    import torch

    from drand_tpu_torch.crypto.fields import P, Fp2
    from drand_tpu_torch.ops import curve as cv, field, h2c, wire
    from drand_tpu_torch.ops.engine import _g2_from_words, decode_sig
    from drand_tpu_torch.ops.limb import words_to_halves
    from drand_tpu_torch.tools._common import max_abs_err, time_ms, time_once

    dev = state["device"]
    chain = _chain(state)
    span = []
    for bcn in chain[:SPAN_LANES // 2]:
        span += [bcn.signature, bcn.signature_v2]
    b_g2 = Fp2(4, 4)

    def encode(x, flag):
        out = bytearray(x.to_bytes())
        out[0] |= 0x80 | (0x20 if flag else 0)
        return bytes(out)

    off, outside = [], []
    while len(off) < 4 or len(outside) < 4:
        x = Fp2(rng.randrange(P), rng.randrange(P))
        on = (x * x * x + b_g2).is_square()
        (outside if on else off).append(x)
    good = span[0]
    rejected = [bytes([good[0] & 0x7F]) + good[1:], bytes([0xC0]) + bytes(95),
                good[:95], good[:48] + P.to_bytes(48, "big")]
    group = wire.decompress_group_size()
    warp = 32 // group
    # the chain's last signatures with and without the sort flag go into
    # the mixed warp, which starts at the last warp boundary before them
    flag_set = [bool(sg[0] & 0x20) for sg in span]
    pick = [len(span) - 1 - flag_set[::-1].index(f) for f in (True, False)]
    rest = [sg for i, sg in enumerate(span) if i not in pick]
    mixed_at = len(rest) // warp * warp             # 496 = 62 warps
    mixed = [span[i] for i in pick] + [
        encode(off[0], 0), encode(off[1], 1), encode(outside[0], 0),
        encode(outside[1], 1)] + rejected[:2]
    sigs = rest[:mixed_at] + mixed + rest[mixed_at:] + [
        encode(off[2], 1), encode(off[3], 0), encode(outside[2], 1),
        encode(outside[3], 0)] + rejected[2:]
    if len(mixed) != warp or len(sigs) != WIRE_LANES:
        raise RuntimeError(f"the mixed K6 warp is not one warp at {mixed_at}")
    xs, sign, valid = h2c.sigs_to_x(sigs)
    x = torch.from_numpy(xs).to(dev)
    sg = torch.from_numpy(sign.astype(np.int32)).to(dev)
    xy_k, ok_k = wire.decompress_g2(x, sg)
    field.N_FP_PRODUCTS = 0
    (xy_p, ok_p), plain_ms = time_once(lambda: h2c.decompress_plain(x, sg))
    full = field.N_FP_PRODUCTS / WIRE_LANES
    err = max(max_abs_err(xy_k, xy_p), max_abs_err(ok_k, ok_p))
    sizes_err = {}
    for label, lo, hi in (("n1", 0, 1), ("n3", 0, 3), ("n4", 0, 4),
                          ("n128", 0, 128),
                          ("mixed_warp", mixed_at, mixed_at + warp)):
        xy_n, ok_n = wire.decompress_g2(x[lo:hi].contiguous(),
                                        sg[lo:hi].contiguous())
        sizes_err[label] = max(max_abs_err(xy_n, xy_p[lo:hi]),
                               max_abs_err(ok_n, ok_p[lo:hi]))
    lanes = list(range(6)) + list(range(mixed_at, WIRE_LANES))
    xy_h, ok_h = xy_k.cpu().numpy(), ok_k.cpu().numpy()
    host_ok = all(
        (decode_sig(sigs[j]) is None) == (not (ok_h[j] and valid[j]))
        and (not (ok_h[j] and valid[j])
             or _g2_from_words(xy_h[j]) == decode_sig(sigs[j]))
        for j in lanes)
    xh = words_to_halves(x[:1])
    q = (xh, xh, cv.F2.one((1,), dev), torch.zeros(1, dtype=torch.bool,
                                                     device=dev))
    sub_cost = _products(lambda: cv.subgroup_check(cv.F2, q))
    on_curve = [(_f2_of(r) * _f2_of(r) * _f2_of(r) + b_g2).is_square()
                for r in xs]
    products = full * WIRE_LANES - sub_cost * on_curve.count(False)
    bound, by = _bound_ms(products, _nbytes(x, sg, xy_k, ok_k))
    ms = time_ms(lambda: wire.decompress_g2(x, sg), TIMED_LAUNCHES)
    x128, s128 = x[:128].contiguous(), sg[:128].contiguous()
    return {"lanes": WIRE_LANES, "signature_lanes": len(span),
            "group": group, "mixed_warp_lanes": warp,
            "sort_flags_set": sum(flag_set), "off_curve": 4,
            "outside_g2": 4, "rejected_by_byte_split": int((~valid).sum()),
            "accepted": int(ok_k.sum().item()), "max_abs_err": err,
            "sizes_err": sizes_err,
            "host_lanes": len(lanes), "host_match": bool(host_ok),
            "ms": ms,
            "ms_at_128": time_ms(lambda: wire.decompress_g2(x128, s128),
                                 TIMED_LAUNCHES),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms,
            "fp_products_per_lane_all_branches": full,
            "fp_products_per_lane": products / WIRE_LANES}


def _callee_stack(lib: str, state) -> int:
    """The largest stack frame of a library's out-of-line slot operations
    (``state["group_callees"]``, from ptxas)."""
    return max((v["stack_bytes"]
                for v in state["group_callees"][lib].values()), default=0)


def _wire_kernels(state) -> dict:
    """K5 and K6 against their plain versions and the host, at the wire
    span's bucket."""
    rng = random.Random(SEED + 2)
    k5, k6 = _k5_case(state, rng), _k6_case(state, rng)
    for key, name, case, line in (
            ("hash_to_g2", "hash_to_g2_kernel", k5, 65),
            ("decompress_g2", "decompress_g2_kernel", k6, 122)):
        state["kernels"][key] = {
            "name": name, "route": "cuda",
            "source": "drand_tpu_torch/csrc/h2c.cu",
            "replaces": f"drand_tpu/ops/pallas_wire.py:{line}",
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None}
    for key, case in (("hash_to_g2", k5), ("decompress_g2", k6)):
        ptx = state["ptxas"][state["kernels"][key]["name"]]
        state["kernels"][key].update(
            group=case["group"], registers=ptx["registers"],
            stack_bytes=ptx["stack_bytes"],
            callee_stack_bytes=_callee_stack("h2c", state),
            share_of_bound=case["share_of_bound"],
            ms_at_128=case["ms_at_128"])
    state["kernels"]["hash_to_g2"]["ms_at_4"] = k5["ms_at_4"]
    out = {"tolerance": 0, "hash_to_g2": k5, "decompress_g2": k6}
    if (k5["max_abs_err"] or k6["max_abs_err"] or not k5["host_match"]
            or not k6["host_match"] or any(k5["sizes_err"].values())
            or any(k6["sizes_err"].values())
            or not 0 < k6["sort_flags_set"] < k6["signature_lanes"]):
        raise RuntimeError(f"wire kernel mismatch: {out}")
    return out


def phase_kernels(state) -> dict:
    pairing = _pairing_kernels(state)
    curve = _curve_kernels(state)
    wire = _wire_kernels(state)
    return {"pairing": pairing, "curve": curve, "wire": wire,
            "launches": _launch_counts()}


def _library_chain_ms(step, start) -> float:
    """ms of a chain of N_ITERS calls of ``step`` from ``start``: the one
    PyTorch call a step that computes what a probe's step computes (the
    yardstick; the port never calls it)."""
    from drand_tpu_torch.tools._common import time_ms
    from drand_tpu_torch.tools.microbench import N_ITERS

    def chain():
        v = start
        for _ in range(N_ITERS):
            v = step(v)
        return v

    return time_ms(chain, 2)


def _probe_library(dev, rows: int) -> dict:
    """library_ms of each microbench chain at the fill shape: addcmul for
    the CUDA-core chains (y + x·y), matmul for bf16, matmul with TF32
    allowed for f32, _int_mm (after a cast to int8) for int8; none for the
    wide pair. A call the card or the build refuses raises."""
    import torch

    from drand_tpu_torch.tools import microbench as mb

    out = {"chain_wide": None}
    for name in mb.CHAINS:
        x, y = (t.to(dev) for t in mb.chain_inputs(name, mb.CHAIN_FILL))
        out[f"chain_{name}"] = _library_chain_ms(
            lambda v, y=y: torch.addcmul(y, v, y), x)
    for name in mb.MMAS:
        a, b = (t.to(dev) for t in mb.mma_inputs(name, rows))
        key = f"mma_{name}"
        prev = torch.backends.cuda.matmul.allow_tf32
        try:
            if name == "int8_i32":
                out[key] = _library_chain_ms(
                    lambda v, a=a: torch._int_mm(v.to(torch.int8), a), b)
            else:
                torch.backends.cuda.matmul.allow_tf32 = name == "tf32_f32"
                out[key] = _library_chain_ms(lambda v, a=a: v @ a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def _probe_row(kernel: str, source: str, replaces: str, rec: dict,
               ops_s: float, nbytes: int, library_ms) -> dict:
    """A probe kernel's row of the kernels line: its bound is the larger
    of ``ops_s`` (its operations at the peak of the unit it uses) and its
    bytes at the memory rate."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"name": kernel, "route": "cuda",
            "source": f"drand_tpu_torch/csrc/{source}", "replaces": replaces,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": library_ms}


def phase_probes(state) -> dict:
    """The three probes of ``drand_tpu_torch/tools``. Each tool's run is
    its main path: the launch counts are set to 0 just before the three
    runs and read just after, and every probe kernel must have launched.
    The runs check every kernel against its plain version themselves
    (and raise); the kernels line gets each kernel at the shape that fills
    the card, with its bound at the peak of the unit it uses and its
    library yardstick. The Miller step's row is the catch-up bucket: timed
    in the tool's run, and held against its plain version and K1 on the
    kernels phase's lanes, every lane with its own check."""
    import torch

    from drand_tpu_torch.ops import field
    from drand_tpu_torch.tools import microbench as mb
    from drand_tpu_torch.tools import proto_miller_grid as mg
    from drand_tpu_torch.tools import proto_mxu as pm
    from drand_tpu_torch.tools._common import max_abs_err, time_once

    dev = state["device"]
    counters = (mb.LAUNCHES, pm.LAUNCHES, mg.LAUNCHES)
    for counts in counters:
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        bench = mb.run(PROBE_REPS, dev)
        redc = pm.run(128, 64, dev, reps=PROBE_REPS)
        grid = mg.run(128, dev, reps=PROBE_REPS)
    runs_s = time.perf_counter() - t0
    launches = {k: v for counts in counters for k, v in counts.items()}
    if not all(launches.values()):
        raise RuntimeError(f"probe kernels not launched: {launches}")
    state["probe_launches"] = launches

    fill, rows = bench["fill"], mb.shapes(dev)["fill"][1]
    n = mb.CHAIN_FILL[0] * mb.CHAIN_FILL[1]
    library = _probe_library(dev, rows)
    ops_s = {"int32": mb.N_ITERS * n / INT32_MAD_PER_S,
             "wide": 2 * mb.N_ITERS * n / INT32_MAD_PER_S,
             "f32": fill["vpu_f32"]["ops"] / F32_FLOP_PER_S,
             "bf16": fill["vpu_bf16"]["ops"] / BF16_FLOP_PER_S}
    for name in (*mb.CHAINS, "wide"):
        # x, y and the output (the wide pair also its carry), once each
        nbytes = n * (2 if name == "bf16" else 4) * (4 if name == "wide"
                                                     else 3)
        kernel = "chain_i32_kernel" if name == "int32" else \
            f"chain_{name}_kernel"
        state["kernels"][f"chain_{name}"] = _probe_row(
            kernel, "microbench.cu", "tools/microbench.py:58",
            fill[f"vpu_{name}"], ops_s[name], nbytes,
            library[f"chain_{name}"])
    for name, (in_dt, out_dt, _) in mb.MMAS.items():
        rec = fill[f"mma_{name}"]
        isz, osz = (torch.empty(0, dtype=d).element_size()
                    for d in (in_dt, out_dt))
        nbytes = mb.MMA_DIM * (mb.MMA_DIM * isz + rows * (isz + osz))
        kernel = {"bf16_f32": "mma_bf16_kernel", "int8_i32": "mma_s8_kernel",
                  "tf32_f32": "mma_tf32_kernel"}[name]
        state["kernels"][f"mma_{name}"] = _probe_row(
            kernel, "microbench.cu", "tools/microbench.py:67", rec,
            rec["ops"] / TENSOR_OPS_PER_S[name], nbytes, library[f"mma_{name}"])

    rf = redc["fill"]
    products = rf["cuda"]["iters"] * rf["cuda"]["lanes"]
    nbytes = 3 * rf["cuda"]["lanes"] * 48           # a, b and the output
    for key, ops in (
            ("mont_chain_cuda", products * MAD_PER_FP_PRODUCT / INT32_MAD_PER_S),
            ("mont_chain_tc",
             max(products * MAD_PER_PRODUCT_ON_CORES / INT32_MAD_PER_S,
                 products * TENSOR_OPS_PER_REDC
                 / TENSOR_OPS_PER_S["int8_i32"]))):
        state["kernels"][key] = _probe_row(
            f"{key}_kernel", "mxu_redc.cu", "tools/proto_mxu.py:111",
            rf[key.rsplit("_", 1)[1]], ops, nbytes, None)

    # the catch-up bucket's checks, every lane its own (the kernels phase)
    xp, yp, q, k1_out = state["k1_main"]
    f_k = mg.miller_grid(xp, yp, q)
    field.N_FP_PRODUCTS = 0
    f_p, plain_ms = time_once(lambda: mg.miller_grid_plain(xp, yp, q))
    products = field.N_FP_PRODUCTS
    err = max_abs_err(f_k, f_p)
    k1_err = max_abs_err(f_k, k1_out)
    state["kernels"]["miller_step"] = _probe_row(
        "miller_step_kernel", "pairing.cu", "tools/proto_miller_grid.py:32",
        {"max_abs_err": max(err, k1_err), "plain_ms": plain_ms,
         "ms": grid[xp.shape[0]]["grid_ms"]},
        products * MAD_PER_FP_PRODUCT / INT32_MAD_PER_S,
        _nbytes(xp, yp, q, f_k), None)
    if err or k1_err:
        raise RuntimeError(f"miller_step: {err} against its plain version, "
                           f"{k1_err} against K1")
    return {"runs_seconds": runs_s, "launches": launches,
            "microbench": bench, "proto_mxu": redc,
            "proto_miller_grid": {str(b): r for b, r in grid.items()},
            "miller_step_fp_products_per_check": products / xp.shape[0],
            "ptxas": mg.ptxas_rows(),
            "tolerances": {"abs": mb.ABS_TOL,
                           "rel_to_max_by_steps": mb.REL_TOL}}


def _group_key():
    from drand_tpu_torch.crypto.poly import PriPoly

    return PriPoly.random(GROUP_T, seed=GROUP_TAG).commit().commit()


def phase_catchup(state) -> dict:
    """The host-prep path: ``BatchedEngine(wire_prep=False)`` over the
    first CATCHUP_ROUNDS rounds, V1 of BAD_V1 and V2 of HOST_BAD_V2
    corrupted — host hashing and decoding, one K1/K2 launch."""
    from drand_tpu_torch import metrics
    from drand_tpu_torch.ops.engine import BatchedEngine

    chain = _chain(state)
    beacons = _corrupt(chain[:CATCHUP_ROUNDS], BAD_V1, HOST_BAD_V2)
    eng = BatchedEngine(device=state["device"], wire_prep=False)
    checks = 2 * CATCHUP_ROUNDS
    if eng._bucket(checks) != MAIN_BUCKET:
        raise RuntimeError(f"catchup bucket {eng._bucket(checks)}")
    eng.check_bucket(MAIN_BUCKET)              # gate launches come first
    state["engine"] = eng
    for k in eng.stage_seconds:
        eng.stage_seconds[k] = 0.0
    checks0, pairs0 = metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS
    _reset_launches()
    t1 = time.perf_counter()
    verdicts = eng.verify_beacons(_group_key(), beacons)
    wall = time.perf_counter() - t1
    launches = _launch_counts()
    d_checks = metrics.N_PRODUCT_CHECKS - checks0
    d_pairs = metrics.N_MILLER_PAIRS - pairs0
    state["main_launches"] = launches

    bad = [i for i, v in enumerate(verdicts.tolist()) if not v]
    st = eng.stage_seconds
    out = {"rounds": CATCHUP_ROUNDS, "checks": checks,
           "generate_seconds": state["chain_seconds"], "false_at": bad,
           "meter_deltas": {"product_checks": d_checks, "miller_pairs": d_pairs},
           "launches": launches,
           "host_seconds": {"hash": st["hash"], "decode": st["decode"],
                            "pack": st["pack"]},
           "device_seconds": st["device"], "wall_seconds": wall,
           "beacons_per_s": CATCHUP_ROUNDS / wall,
           "device_pairs_per_s": d_pairs / st["device"] if st["device"] else None}
    expect_launches = _launches(miller_loop=1, final_exp_verdict=1)
    if bad != [BAD_V1, HOST_BAD_V2] or d_checks != 1 \
            or d_pairs != 4 * CATCHUP_ROUNDS or launches != expect_launches:
        raise RuntimeError(f"catchup: {out}")
    return out


def phase_catchup_wire(state) -> dict:
    """The wire path: the default engine over the whole N_ROUNDS-round
    chain, clean (the wire-RLC tier: one combined product check) and then
    with V1 of BAD_V1 and V2 of BAD_V2 corrupted (the combined check
    fails and the per-item wire path decides). The known-answer gates run
    first; verdicts, meter deltas and launches are checked exactly."""
    from drand_tpu_torch import metrics
    from drand_tpu_torch.ops.engine import BatchedEngine

    chain = _chain(state)
    key = _group_key()
    eng = BatchedEngine(device=state["device"])
    checks = 2 * N_ROUNDS
    if not eng.wire_rlc_active(checks) or eng._bucket(checks) != WIRE_LANES:
        raise RuntimeError("the span does not take the wire-RLC tier at "
                           f"bucket {WIRE_LANES}")
    t0 = time.perf_counter()
    eng.check_wire(checks)                     # gate launches come first
    out = {"rounds": N_ROUNDS, "checks": checks,
           "gate_seconds": time.perf_counter() - t0,
           "kat": eng.introspect()["kat"]}
    chunks = checks // WIRE_LANES
    clean = _launches(miller_loop=1, final_exp_verdict=1, msm=chunks,
                      hash_to_g2=chunks, decompress_g2=chunks)
    corrupted = _launches(miller_loop=1 + chunks,
                          final_exp_verdict=1 + chunks, msm=chunks,
                          hash_to_g2=2 * chunks, decompress_g2=2 * chunks)
    for label, beacons, want_false, want_launches, want_meters in (
            ("clean", chain, [], clean, (1, 2)),
            ("corrupted", _corrupt(chain, BAD_V1, BAD_V2), [BAD_V1, BAD_V2],
             corrupted, (2, 2 + 2 * checks))):
        for k in eng.stage_seconds:
            eng.stage_seconds[k] = 0.0
        checks0, pairs0 = metrics.N_PRODUCT_CHECKS, metrics.N_MILLER_PAIRS
        _reset_launches()
        t1 = time.perf_counter()
        verdicts = eng.verify_beacons(key, beacons)
        wall = time.perf_counter() - t1
        launches = _launch_counts()
        meters = (metrics.N_PRODUCT_CHECKS - checks0,
                  metrics.N_MILLER_PAIRS - pairs0)
        st = dict(eng.stage_seconds)
        run = {"false_at": [i for i, v in enumerate(verdicts.tolist())
                            if not v],
               "meter_deltas": {"product_checks": meters[0],
                                "miller_pairs": meters[1]},
               "launches": launches,
               "host_seconds": {k: st[k] for k in ("prep", "pack", "hash",
                                                   "decode")},
               "device_seconds": st["device"], "wall_seconds": wall,
               "beacons_per_s": N_ROUNDS / wall}
        out[label] = run
        if (run["false_at"] != want_false or launches != want_launches
                or meters != want_meters):
            raise RuntimeError(f"catchup_wire {label}: {run}")
    state["wire_launches"] = out["corrupted"]["launches"]
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
    one = _launches(miller_loop=1, final_exp_verdict=1, msm=1, horner=1)
    tail = _launches(miller_loop=2, final_exp_verdict=2, msm=2, horner=1)
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
    want = _launches(horner=1)
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
    _start_chain(state)
    try:
        return _run_phases(state, start)
    finally:
        state["chain_thread"].join()   # its workers are waited for too


def _run_phases(state, start: float) -> int:
    """Every phase in order, its JSON line, then the closing lines."""
    import torch

    failed = []
    for name, phase in (("build", phase_build), ("kernels", phase_kernels),
                        ("probes", phase_probes),
                        ("catchup", phase_catchup),
                        ("catchup_wire", phase_catchup_wire),
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
    # launches on each kernel's own main path: the corrupted wire span
    # (the catch-up metric's path) for K1, K2, K5, K6 and the MSM at the
    # wire-RLC combine's shape, the 67-of-100 round (all partials valid)
    # for the MSM and the Horner, one run of each probe tool for the probe
    # kernels
    launches = {**state["main_launches"], **state["probe_launches"],
                **{k: state["threshold_launches"][k] for k in ("msm",
                                                               "horner")},
                **{k: state["wire_launches"][k] for k in (
                    "hash_to_g2", "decompress_g2", "miller_loop",
                    "final_exp_verdict")},
                "msm_wire_rlc": state["wire_launches"]["msm"]}
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
