"""Throughput of the card's compute primitives that the field arithmetic
could be built from: dependent chains on the CUDA cores and on the tensor
cores (the kernels of ``csrc/microbench.cu``), their wrappers with launch
counters, and their plain PyTorch versions.

Counterpart of the JAX package's ``tools/microbench.py`` (the Pallas
calls ``_pallas1`` over ``vpu_kernel`` and ``mxu_kernel``):

- ``chain``: x <- x*y + y, ``N_ITERS`` dependent steps, one thread per
  element, in int32 (IMAD), f32 (FFMA) and bf16 (HFMA2, two elements a
  thread) — the tool's VPU cases;
- ``wide_chain``: (c, x) <- x*y + c, the 32x32->64 multiply-add pair
  (``mad.lo.cc.u32`` / ``madc.hi.u32``) that ``fp.cuh``'s CIOS product is
  built from: the card's counterpart of the tool's "int32 multiply-add
  (current ops/bl.py core)";
- ``mma_chain``: acc <- (acc as the input type) @ a, a 128 x 128
  constant, ``N_ITERS`` dependent products through ``mma.sync``: bf16 ->
  f32, int8 -> int32, and f32 -> f32 as TF32 (the card's f32 path on the
  tensor cores) — the tool's MXU cases.

Each case runs at the JAX tool's shape — a (256, 128) tile, one 128 x 128
chain — and, on the card, at a shape that fills it: ``CHAIN_FILL``
elements (about 31 waves of 2,048 threads on each of 132 SMs) and
``FILL_BLOCKS_PER_SM`` chains of 128 rows per SM. The tool's shapes fill
one TPU core; here (256, 128) gives 132 SMs about 248 threads each and one
128 x 128 chain occupies one SM. Every run checks each kernel against its
plain version at both shapes and raises on a mismatch. The float tensor-
core chains are checked where rounding noise cannot hide a fault: word
for word on a scaled signed permutation over ``N_ITERS`` steps, and
within ``REL_TOL`` on the random chain over each of ``CHECK_ITERS``
steps; their random chain over ``N_ITERS`` steps is timed.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. On the CPU the tool runs the plain
versions at the JAX tool's shapes only.

Usage: python -m drand_tpu_torch.tools.microbench [reps] [--device cpu]
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ._common import max_abs_err, parse_args, time_ms, time_once

N_ITERS = 512
CHECK_ITERS = (1, 8)             # the float tensor-core chains' checks
TOOL_SHAPE = (256, 128)          # the JAX tool's VPU tile
CHAIN_FILL = (8192, 1024)        # fills the card (see the module docstring)
MMA_DIM = 128                    # the chain's square width (the tool's m)
FILL_BLOCKS_PER_SM = 2           # 128-row chains per SM at the fill shape
SEED = 1512

# the CUDA-core chains: dtype and C kind of vpu_chain_launch
CHAINS = {"int32": (torch.int32, 0), "f32": (torch.float32, 1),
          "bf16": (torch.bfloat16, 2)}
WIDE_KIND = 3
# the tensor-core chains: input dtype, output dtype, C kind of
# mma_chain_launch
MMAS = {"bf16_f32": (torch.bfloat16, torch.float32, 0),
        "int8_i32": (torch.int8, torch.int32, 1),
        "tf32_f32": (torch.float32, torch.float32, 2)}

# Tolerances of the float chains against their plain versions. The
# CUDA-core chains contract x*y + y into one rounding (fma) where the
# plain version rounds twice; with y in [0.25, 0.5) and x in [0, 1) the
# chain contracts towards y/(1-y) < 1, so the two stay within two units in
# the last place: below 2^-22 (f32) and 2^-7 (bf16).
# The tensor-core chains sum exact products in f32 where the plain version
# sums them in float64 and rounds once, relative to the largest magnitude:
# - one step: the sums alone, 2^-22 on the CPU with f32 sums in blocks of
#   K; sums in f16 or bf16 part by 2^-10 or 2^-7, so 2^-14 holds the
#   accumulator to f32;
# - 8 steps: a flipped bf16 or TF32 rounding of acc parts two chains, and
#   the parting grows as rounding noise (f32 sums on the CPU: 2^-8.1 bf16,
#   2^-10.6 TF32; 5.9% and 0.69% after 512 steps, which no tight bound can
#   tell from a fault). The bounds leave a factor of four to six.
# The scaled signed permutation (``mma_inputs(permutation=True)``) is
# exact whatever the sums' order or precision, and rounds acc to the input
# type at every step: held word for word, it checks the fragment layouts,
# the feedback of C into A and the rounding of that conversion.
ABS_TOL = {"f32": 1e-5, "bf16": 2.0 ** -5}
REL_TOL = {"bf16_f32": {1: 2.0 ** -14, 8: 2.0 ** -6},
           "tf32_f32": {1: 2.0 ** -14, 8: 2.0 ** -8}}
# |entries| of the scaled signed permutation: 1 plus the input type's
# unit in the last place at 1, so that a step's products need rounding
PERM_SCALE = {"bf16_f32": 1.0 + 2.0 ** -7, "int8_i32": 1.0,
              "tf32_f32": 1.0 + 2.0 ** -10}

# The instruction each kernel's loop must keep (opcode prefix, a part of
# it, at least how many in the SASS): one per step of the 16-fold
# unrolled CUDA-core loops, every mma of one step of a tensor-core chain.
SASS_WANT = {"chain_i32_kernel": ("IMAD", "", 16),
             "chain_f32_kernel": ("FFMA", "", 16),
             "chain_bf16_kernel": ("HFMA2", "BF16", 16),
             "chain_wide_kernel": ("IMAD", "", 16),
             "mma_bf16_kernel": ("HMMA", "BF16", 128),
             "mma_s8_kernel": ("IMMA", "", 64),
             "mma_tf32_kernel": ("HMMA", "TF32", 256)}

# Launch counts of the CUDA kernels (plain ints; counted where launched).
LAUNCHES = {"chain_int32": 0, "chain_f32": 0, "chain_bf16": 0,
            "chain_wide": 0, "mma_bf16_f32": 0, "mma_int8_i32": 0,
            "mma_tf32_f32": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def chain_plain(x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    """x <- x*y + y, ``iters`` times: int32 wraps mod 2^32; f32 and bf16
    round the product and the sum each (the kernels use one fma)."""
    if x.dtype == torch.int32:
        a, b = x.long(), y.long()
        for _ in range(iters):
            a = _wrap32(a * b + b).long()
        return a.to(torch.int32)
    a = x
    for _ in range(iters):
        a = a * y + y
    return a


def wide_chain_plain(x: torch.Tensor, y: torch.Tensor, iters: int):
    """(c, x) <- x*y + c from c = 0, ``iters`` times, on uint32 values held
    as int32 bit patterns; returns (x, c). The 64-bit product is built
    from 16-bit halves so that every int64 intermediate stays exact."""
    m = 0xFFFFFFFF
    a, b = x.long() & m, y.long() & m
    c = torch.zeros_like(a)
    bl, bh = b & 0xFFFF, b >> 16
    for _ in range(iters):
        al, ah = a & 0xFFFF, a >> 16
        mid = al * bh + ah * bl                      # < 2^33
        lo = al * bl + ((mid & 0xFFFF) << 16) + c    # < 2^34
        c = ah * bh + (mid >> 16) + (lo >> 32)
        a = lo & m
    return _wrap32(a), _wrap32(c)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mma_chain_plain(a: torch.Tensor, b: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """acc <- (acc as a's type) @ a from acc = b, ``iters`` times. The
    products are summed in float64: exact for int8 (|sum| <= 2^21), and
    for bf16 and TF32 the exact products rounded once to f32."""
    if a.dtype == torch.int8:
        a64, acc = a.double(), b.to(torch.int32)
        for _ in range(iters):
            acc = (acc.to(torch.int8).double() @ a64).to(torch.int32)
        return acc
    if a.dtype == torch.bfloat16:
        a64, acc = a.double(), b.float()
        for _ in range(iters):
            acc = (acc.to(torch.bfloat16).double() @ a64).float()
        return acc
    a64, acc = tf32_round(a).double(), b
    for _ in range(iters):
        acc = (tf32_round(acc).double() @ a64).float()
    return acc


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def _lib():
    from ..ops import _build

    return _build.library("microbench")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_pair(name: str, x: torch.Tensor, y: torch.Tensor, dtypes) -> None:
    for t in (x, y):
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype}, expected one of "
                            f"{dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if x.dtype != y.dtype or x.device != y.device:
        raise ValueError(f"{name}: operands differ in dtype or device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def chain(x: torch.Tensor, y: torch.Tensor, iters: int = N_ITERS):
    """The CUDA-core chain of x's dtype (int32, float32, bfloat16)."""
    _check_pair("chain", x, y, [d for d, _ in CHAINS.values()])
    if x.shape != y.shape:
        raise ValueError(f"chain: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} differ")
    if x.device.type == "cpu":
        return chain_plain(x, y, iters)
    name = next(k for k, (d, _) in CHAINS.items() if d == x.dtype)
    if x.dtype == torch.bfloat16 and x.numel() % 2:
        raise ValueError("chain: bf16 runs two elements a thread; give an "
                         "even count")
    out = torch.empty_like(x)
    err = _lib().vpu_chain_launch(CHAINS[name][1], _ptr(x), _ptr(y),
                                  _ptr(out), None, x.numel(), iters,
                                  _stream(x.device))
    if err != 0:
        raise RuntimeError(f"chain_{name}_kernel: CUDA error {err}")
    LAUNCHES[f"chain_{name}"] += 1
    return out


def wide_chain(x: torch.Tensor, y: torch.Tensor, iters: int = N_ITERS):
    """The multiply-with-carry chain on int32 bit patterns -> (x, c)."""
    _check_pair("wide_chain", x, y, [torch.int32])
    if x.shape != y.shape:
        raise ValueError("wide_chain: shapes differ")
    if x.device.type == "cpu":
        return wide_chain_plain(x, y, iters)
    out, carry = torch.empty_like(x), torch.empty_like(x)
    err = _lib().vpu_chain_launch(WIDE_KIND, _ptr(x), _ptr(y), _ptr(out),
                                  _ptr(carry), x.numel(), iters,
                                  _stream(x.device))
    if err != 0:
        raise RuntimeError(f"chain_wide_kernel: CUDA error {err}")
    LAUNCHES["chain_wide"] += 1
    return out, carry


def mma_chain(a: torch.Tensor, b: torch.Tensor, iters: int = N_ITERS):
    """The tensor-core chain of a's dtype: a (128, 128), b (m, 128) with m
    a multiple of 128 -> acc (m, 128) of the accumulator type."""
    _check_pair("mma_chain", a, b, [d for d, _, _ in MMAS.values()])
    if tuple(a.shape) != (MMA_DIM, MMA_DIM) or b.dim() != 2 \
            or b.shape[1] != MMA_DIM or b.shape[0] % MMA_DIM:
        raise ValueError(f"mma_chain: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}; want (128, 128) and (128k, 128)")
    if a.device.type == "cpu":
        return mma_chain_plain(a, b, iters)
    name = next(k for k, (d, _, _) in MMAS.items() if d == a.dtype)
    _, out_dtype, kind = MMAS[name]
    out = torch.empty(b.shape, dtype=out_dtype, device=b.device)
    err = _lib().mma_chain_launch(kind, _ptr(a), _ptr(b), _ptr(out),
                                  b.shape[0], iters, _stream(a.device))
    if err != 0:
        raise RuntimeError(f"mma_{name} kernel: CUDA error {err}")
    LAUNCHES[f"mma_{name}"] += 1
    return out


# ---------------------------------------------------------------------------
# Inputs and the run
# ---------------------------------------------------------------------------

def chain_inputs(name: str, shape, seed: int = SEED):
    """x, y from a numpy seed: int32 and the wide chain over all 2^32 bit
    patterns (wrapping included); f32 and bf16 with x in [0, 1) and y in
    [0.25, 0.5), which keeps the chain finite."""
    rng = np.random.default_rng(seed)
    if name in ("int32", "wide"):
        x, y = (rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                .astype(np.int32) for _ in range(2))
        return torch.from_numpy(x), torch.from_numpy(y)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(np.float32))
    y = torch.from_numpy(rng.uniform(0.25, 0.5, shape).astype(np.float32))
    dtype = CHAINS[name][0]
    return x.to(dtype), y.to(dtype)


def mma_inputs(name: str, rows: int, seed: int = SEED, permutation=False):
    """a (128, 128), b (rows, 128) from a numpy seed. int8: uniform over
    [-128, 127]. bf16 and TF32: a an orthogonal matrix (QR of a Gaussian),
    b standard normal, which keeps the chain finite. ``permutation``: a is
    a signed permutation matrix scaled by ``PERM_SCALE`` instead: every
    sum has one term, so every chain is exact up to the rounding of acc
    to the input type, and the kernel must equal its plain version word
    for word."""
    rng = np.random.default_rng(seed)
    in_dtype = MMAS[name][0]
    if permutation:
        a = np.zeros((MMA_DIM, MMA_DIM))
        a[np.arange(MMA_DIM), rng.permutation(MMA_DIM)] = \
            rng.choice([-1.0, 1.0], MMA_DIM) * PERM_SCALE[name]
    elif in_dtype == torch.int8:
        a = rng.integers(-128, 128, (MMA_DIM, MMA_DIM))
    else:
        a = np.linalg.qr(rng.standard_normal((MMA_DIM, MMA_DIM)))[0]
    if in_dtype == torch.int8:
        b = rng.integers(-128, 128, (rows, MMA_DIM))
        return (torch.from_numpy(a.astype(np.int8)),
                torch.from_numpy(b.astype(np.int8)))
    b = rng.standard_normal((rows, MMA_DIM))
    return (torch.from_numpy(a.astype(np.float32)).to(in_dtype),
            torch.from_numpy(b.astype(np.float32)).to(in_dtype))


def within(name: str, err: float, ref: torch.Tensor,
           iters: int = N_ITERS) -> bool:
    """Whether a kernel's max_abs_err against its plain version (``ref``)
    over ``iters`` steps is within the case's stated tolerance (0 for the
    integer chains; a float tensor-core chain only at ``CHECK_ITERS``)."""
    if name in ABS_TOL:
        return err <= ABS_TOL[name]
    if name in REL_TOL:
        return err <= (REL_TOL[name][iters]
                       * float(ref.double().abs().max().item()))
    return err == 0


def shapes(device: torch.device) -> dict:
    """{label: (chain shape, mma rows)}: the JAX tool's shapes, and on the
    card the shapes that fill it."""
    out = {"tool": (TOOL_SHAPE, MMA_DIM)}
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        out["fill"] = (CHAIN_FILL, MMA_DIM * FILL_BLOCKS_PER_SM * sms)
    return out


def _case(device, reps, kernel, plain, args, name, ops) -> dict:
    """One case: kernel against plain (raises outside the tolerance), the
    kernel's time over ``reps`` calls and the plain version's over one."""
    args = [t.to(device) for t in args]
    got = kernel(*args)
    want, plain_ms = time_once(lambda: plain(*args), device)
    got, want = (got if isinstance(got, tuple) else (got,),
                 want if isinstance(want, tuple) else (want,))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    if not within(name, err, want[0]):
        raise RuntimeError(f"{name}: kernel differs from its plain version "
                           f"by {err}")
    ms = time_ms(lambda: kernel(*args), reps, device)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "ops": ops}


def _mma_case(device, reps, name, rows) -> dict:
    """One tensor-core case. Checks (raising on a mismatch): the scaled
    signed permutation over ``N_ITERS`` steps word for word, where the
    plain version is timed; the random chain over ``N_ITERS`` steps word
    for word (int8), or over each of ``CHECK_ITERS`` steps within
    ``REL_TOL`` (bf16, TF32). The random chain over ``N_ITERS`` steps is
    timed over ``reps`` calls and must be finite."""
    a, b = (t.to(device) for t in mma_inputs(name, rows))
    pa, pb = (t.to(device) for t in mma_inputs(name, rows, permutation=True))
    want, plain_ms = time_once(lambda: mma_chain_plain(pa, pb, N_ITERS),
                               device)
    errs = {"permutation": max_abs_err(mma_chain(pa, pb), want)}
    if errs["permutation"]:
        raise RuntimeError(f"mma_{name}: the permutation chain differs from "
                           f"its plain version by {errs['permutation']}")
    for iters in CHECK_ITERS if name in REL_TOL else (N_ITERS,):
        want = mma_chain_plain(a, b, iters)
        errs[iters] = max_abs_err(mma_chain(a, b, iters), want)
        if not within(name, errs[iters], want, iters):
            raise RuntimeError(f"mma_{name}: {iters} steps differ from the "
                               f"plain version by {errs[iters]}")
    if not mma_chain(a, b).isfinite().all():
        raise RuntimeError(f"mma_{name}: the timed chain is not finite")
    ms = time_ms(lambda: mma_chain(a, b), reps, device)
    return {"max_abs_err": max(errs.values()), "errors": errs, "ms": ms,
            "plain_ms": plain_ms, "ops": 2 * N_ITERS * rows * MMA_DIM ** 2}


def run(reps: int = 5, device: torch.device | str = "cuda") -> dict:
    """Every case at every shape of ``shapes(device)``: checked against
    the plain version, timed, printed as the JAX tool prints it; returns
    {shape label: {case: record}}."""
    device = torch.device(device)
    results = {}
    for label, (cshape, rows) in shapes(device).items():
        res = results[label] = {}
        n = cshape[0] * cshape[1]
        print(f"-- {label} shape: chains {cshape}, mma ({rows}, {MMA_DIM}) "
              f"@ ({MMA_DIM}, {MMA_DIM}), {N_ITERS} iterations")
        for name in CHAINS:
            # x*y + y: 2 ops per element and step (the tool's count)
            res[f"vpu_{name}"] = r = _case(
                device, reps, chain, lambda x, y: chain_plain(x, y, N_ITERS),
                chain_inputs(name, cshape), name, 2 * N_ITERS * n)
            line = f"vpu_{name:9s} {r['ops'] / r['ms'] / 1e6:10.1f} Gop/s"
            if name == "int32":
                line += f"  {N_ITERS * n / r['ms'] / 1e9:8.3f} T int32 MAD/s"
            print(f"{line}  ({r['ms']:.3f} ms)")
        # two 32-bit multiply-adds (low and high word) per element and step
        res["vpu_wide"] = r = _case(
            device, reps, wide_chain,
            lambda x, y: wide_chain_plain(x, y, N_ITERS),
            chain_inputs("wide", cshape), "wide", 4 * N_ITERS * n)
        print(f"vpu_wide      {r['ops'] / r['ms'] / 1e6:10.1f} Gop/s  "
              f"{2 * N_ITERS * n / r['ms'] / 1e9:8.3f} T int32 MAD/s  "
              f"({r['ms']:.3f} ms)")
        for name in MMAS:
            res[f"mma_{name}"] = r = _mma_case(device, reps, name, rows)
            tf32 = "  (f32 through TF32)" if name == "tf32_f32" else ""
            print(f"mma_{name:9s} {r['ops'] / r['ms'] / 1e9:10.2f} Top/s  "
                  f"({r['ms']:.3f} ms){tf32}")
    if device.type == "cuda":
        results["sass"] = check_sass()
    return results


def check_sass() -> dict | None:
    """Each kernel's SASS opcodes (``cuobjdump -sass``) and the count of
    the instruction its loop must keep; raises where a loop lost it.
    None where the toolkit has no cuobjdump."""
    from ..ops import _build

    counts = _build.sass_counts("microbench")
    if counts is None:
        print("sass: no cuobjdump")
        return None
    out = {}
    for kernel, (prefix, part, least) in SASS_WANT.items():
        n = _build.sass_count(counts, kernel, prefix, part)
        ops = {op: k for fn, fops in counts.items() if kernel in fn
               for op, k in fops.items()}
        out[kernel] = {"instruction": prefix + (f"*{part}" if part else ""),
                       "count": n, "least": least, "opcodes": ops}
        print(f"sass {kernel}: {n} x {out[kernel]['instruction']}")
        if n < least:
            raise RuntimeError(f"{kernel}: {n} {prefix} in its SASS, want "
                               f"at least {least}")
    return out


def main(argv=None) -> int:
    (reps,), device = parse_args(argv, "microbench", [("reps", 5)])
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions)")
    run(reps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
