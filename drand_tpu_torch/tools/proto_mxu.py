"""Montgomery REDC with its two constant-operand products on the int8
tensor cores, against the all-CUDA-core product: the two kernels of
``csrc/mxu_redc.cu``, their wrapper with launch counters, and their plain
PyTorch versions.

Counterpart of the JAX package's ``tools/proto_mxu.py`` (the Pallas call
over ``_chain_kernel``), which timed a chain of stacked Montgomery
products with the all-VPU ``bl.mont_mul`` and with ``mont_mul_mxu``
(t_lo·N' and m·p as int8 products on the matrix unit) and checked both
against the host. Here, in the port's canonical 12 x 32-bit Montgomery
words (R = 2^384):

- ``mont_chain(..., tensor_cores=False)``: ``fp.cuh``'s CIOS product,
  one thread per lane (``mont_chain_cuda_kernel``);
- ``mont_chain(..., tensor_cores=True)``: a·b on the CUDA cores, the two
  products by constants as u8 x u8 -> s32 ``mma.sync`` against the byte
  Toeplitz matrices ``G_NPRIME`` and ``G_P`` (``mont_chain_tc_kernel``).

The split is this port's own: a 384-bit value is 48 bytes, and a
product by a constant c has column sums Σ c_(k−i)·x_i ≤ 48·255² < 2^22,
exact in int32 (the JAX tool's 12-bit-limb matrices are a TPU layout).
The plain versions are ``ops/field.mont_mul`` and ``mont_mul_tc_plain``
(the same byte matrices multiplied exactly, in float64).

Both chains compute a·b^iters mod p in the ordinary domain (a·b·R^-1 on
Montgomery words), which the run checks against the host field code: the
JAX tool expects a·(b·R^-1)^iters, but its ``bl.pack_fp``/``unpack_fp``
convert into and out of the Montgomery domain, so its right outputs read
as wrong there.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Every run checks both kernels against
their plain versions, each other and the host, and raises on a mismatch.

Usage: python -m drand_tpu_torch.tools.proto_mxu [B] [iters] [--device cpu]
"""

from __future__ import annotations

import ctypes
import random
import sys

import numpy as np
import torch

from ..crypto.fields import P
from ..ops import field as fd
from ..ops.limb import (NWORDS, R_MONT, fp_from_words, fp_words,
                        halves_to_words, int_to_words, words_to_halves)
from ._common import max_abs_err, parse_args, time_ms, time_once

STACK = 3                 # the tool's stacked leading dimension (f2_mul's)
N_BYTES = 48              # bytes of a 384-bit value
K_BYTES = 64              # the GEMM's K: two k-steps of 32, bytes 48.. zero
FILL_BLOCKS_PER_SM = 4    # 128-lane blocks per SM at the fill lane count
SEED = 7                  # the tool's random.Random(7)
NPRIME = (-pow(P, -1, R_MONT)) % R_MONT     # -p^-1 mod 2^384
_WORD = 0xFFFFFFFF


def toeplitz_bytes(c: int, rows: int) -> np.ndarray:
    """(rows, 64) uint8: row k = output byte column, column i = input byte;
    G[k][i] = byte k − i of c. G @ x holds the column sums of c·x."""
    cb = c.to_bytes(N_BYTES, "little")
    g = np.zeros((rows, K_BYTES), np.uint8)
    for k in range(rows):
        for i in range(max(0, k - N_BYTES + 1), min(k + 1, N_BYTES)):
            g[k, i] = cb[k - i]
    return g


G_NPRIME = toeplitz_bytes(NPRIME, N_BYTES)       # m = T_lo·N' mod R
G_P = toeplitz_bytes(P, 2 * N_BYTES)             # m·p, all 96 columns
_P_WORDS = [int(w) & _WORD for w in int_to_words(P)]

# mma.sync of one step of the tensor-core chain: 3 + 6 m-tiles x 4 n-tiles
# x 2 k-steps; its SASS must hold at least as many IMMA
IMMA_PER_STEP = (3 + 6) * 4 * 2

# Launch counts of the CUDA kernels (plain ints; counted where launched).
LAUNCHES = {"mont_chain_cuda": 0, "mont_chain_tc": 0}

_DEV: dict[tuple[str, str], torch.Tensor] = {}


def _on(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _DEV.get(key)
    if t is None:
        g = {"nprime": G_NPRIME, "p": G_P}[name]
        t = torch.from_numpy(g).to(device)
        _DEV[key] = t
    return t


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """(..., n) int32 words -> (..., 4n) int64 bytes, little-endian."""
    u = w.long() & _WORD
    return torch.stack([(u >> (8 * i)) & 0xFF for i in range(4)],
                       dim=-1).flatten(-2)


def _column_terms(cols: torch.Tensor) -> torch.Tensor:
    """(..., 4n) byte column sums -> (..., n) terms: four columns a word,
    as the kernel folds them (each < 2^22, so every term < 2^47)."""
    c = cols.unflatten(-1, (-1, 4))
    return c[..., 0] + (c[..., 1] << 8) + (c[..., 2] << 16) + (c[..., 3] << 24)


def _carry(terms: torch.Tensor):
    """Word carries over (..., n) non-negative int64 terms, least
    significant first -> (words in [0, 2^32), the carry out)."""
    words, carry = [], torch.zeros_like(terms[..., 0])
    for j in range(terms.shape[-1]):
        w = terms[..., j] + carry
        words.append(w & _WORD)
        carry = w >> 32
    return torch.stack(words, dim=-1), carry


def _sub_p_once(u: torch.Tensor) -> torch.Tensor:
    """(..., 12) words of u < 2p -> u mod p."""
    d, borrow = [], torch.zeros_like(u[..., 0])
    for j in range(NWORDS):
        v = u[..., j] - _P_WORDS[j] - borrow
        borrow = (v < 0).long()
        d.append(v & _WORD)
    return torch.where((borrow == 0)[..., None], torch.stack(d, dim=-1), u)


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def mont_mul_tc_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R^-1 mod p on (..., 12) int32 words, through the tensor-core
    kernel's split: T = a·b exactly, m = (T mod R)·N' mod R and m·p as
    products of byte vectors with ``G_NPRIME`` and ``G_P`` (exact in
    float64), then (T + m·p)/R and one subtraction of p."""
    fd.N_FP_PRODUCTS += a.numel() // NWORDS
    ab, bb = _words_to_bytes(a), _words_to_bytes(b)
    cols = torch.zeros(ab.shape[:-1] + (2 * N_BYTES,), dtype=torch.int64,
                       device=a.device)
    for i in range(N_BYTES):
        cols[..., i:i + N_BYTES] += ab * bb[..., i:i + 1]
    t, _ = _carry(_column_terms(cols))                   # 24 words
    pad = (0, K_BYTES - N_BYTES)
    x = torch.nn.functional.pad(_words_to_bytes(t[..., :NWORDS]), pad)
    s1 = (x.double() @ _on("nprime", a.device).double().T).long()
    m, _ = _carry(_column_terms(s1))                     # mod R: carry dropped
    x = torch.nn.functional.pad(_words_to_bytes(m), pad)
    s2 = (x.double() @ _on("p", a.device).double().T).long()
    u, _ = _carry(_column_terms(s2) + t)                 # low half is zero
    return _to_int32(_sub_p_once(u[..., NWORDS:]))


def mont_chain_plain(a: torch.Tensor, b: torch.Tensor, iters: int,
                     tensor_cores: bool) -> torch.Tensor:
    """a <- a·b·R^-1 mod p, ``iters`` times: ``ops/field.mont_mul`` (the
    CUDA-core chain's plain version) or ``mont_mul_tc_plain``."""
    if tensor_cores:
        for _ in range(iters):
            a = mont_mul_tc_plain(a, b)
        return a
    ah, bh = words_to_halves(a), words_to_halves(b)
    for _ in range(iters):
        ah = fd.mont_mul(ah, bh)
    return halves_to_words(ah)


# ---------------------------------------------------------------------------
# Wrapper: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def mont_chain(a: torch.Tensor, b: torch.Tensor, iters: int,
               tensor_cores: bool) -> torch.Tensor:
    """The chain on (..., 12) int32 words (any leading shape, one lane per
    row) -> a·b^iters in the ordinary domain, as Montgomery words."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"mont_chain: {name} dtype {t.dtype}, expected "
                            "torch.int32")
        if t.shape != a.shape or t.shape[-1] != NWORDS:
            raise ValueError(f"mont_chain: {name} shape {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"mont_chain: {name} not contiguous on "
                             f"{a.device}")
    if a.device.type == "cpu":
        return mont_chain_plain(a, b, iters, tensor_cores)
    if a.device.type != "cuda":
        raise ValueError(f"mont_chain: unsupported device {a.device}")
    from ..ops import _build
    from ..ops.pairing import _consts_on

    out = torch.empty_like(a)
    n = a.numel() // NWORDS
    consts = _consts_on(a.device)
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (
        consts, a, b, _on("nprime", a.device), _on("p", a.device), out)]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _build.library("mxu_redc").mont_chain_launch(
        ptr[0], consts.numel(), int(tensor_cores), *ptr[1:], n, iters,
        ctypes.c_void_p(stream))
    key = "mont_chain_tc" if tensor_cores else "mont_chain_cuda"
    if err != 0:
        raise RuntimeError(f"{key}_kernel: CUDA error {err}")
    LAUNCHES[key] += 1
    return out


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def chain_inputs(batch: int, seed: int = SEED):
    """(3, batch) host values of a and b from ``random.Random(seed)``, with
    a = b = p − 1 on lane 0 and a = 0 on lane 1, and their words."""
    rnd = random.Random(seed)
    va = [rnd.randrange(P) for _ in range(STACK * batch)]
    vb = [rnd.randrange(P) for _ in range(STACK * batch)]
    va[0] = vb[0] = P - 1
    if len(va) > 1:
        va[1] = 0
    words = [torch.from_numpy(np.stack([fp_words(v) for v in vals]))
             .reshape(STACK, batch, NWORDS) for vals in (va, vb)]
    return va, vb, words


def lane_counts(batch: int, device: torch.device) -> dict:
    """{label: B}: the JAX tool's B and, on the card, a B whose 3·B lanes
    give every SM ``FILL_BLOCKS_PER_SM`` blocks of 128 lanes."""
    out = {"tool": batch}
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        out["fill"] = FILL_BLOCKS_PER_SM * sms * 128 // STACK
    return out


def run(batch: int = 128, iters: int = 64,
        device: torch.device | str = "cuda", reps: int = 5) -> dict:
    """Both chains at each lane count of ``lane_counts``: checked against
    their plain versions (word for word), each other and the host's
    a·b^iters mod p, timed, printed as the JAX tool prints them; returns
    {label: {"cuda": record, "tc": record, "speedup": x}}."""
    device = torch.device(device)
    results = {}
    for label, b_lanes in lane_counts(batch, device).items():
        va, vb, (a, b) = chain_inputs(b_lanes)
        a, b = a.to(device), b.to(device)
        host = [x * pow(y, iters, P) % P for x, y in zip(va, vb)]
        res = results[label] = {}
        outs = {}
        for tc in (False, True):
            key = "tc" if tc else "cuda"
            out = outs[key] = mont_chain(a, b, iters, tc)
            plain, plain_ms = time_once(
                lambda: mont_chain_plain(a, b, iters, tc), device)
            err = max_abs_err(out, plain)
            got = [fp_from_words(w) for w in out.reshape(-1, NWORDS).cpu()
                   .numpy()]
            ok = got == host and err == 0
            print(f"{label} tensor_cores={tc}: correct={ok}")
            if not ok:
                bad = [i for i, (g, e) in enumerate(zip(got, host)) if g != e]
                raise RuntimeError(f"mont_chain tensor_cores={tc}: "
                                   f"max_abs_err {err} against the plain "
                                   f"version, host mismatch on lanes "
                                   f"{bad[:8]}")
            ms = time_ms(lambda: mont_chain(a, b, iters, tc), reps, device)
            n_mm = iters * STACK
            print(f"{label} tensor_cores={tc}: {ms:.3f} ms for {n_mm} stacked "
                  f"mont_muls @ B={b_lanes} -> "
                  f"{n_mm * b_lanes / ms / 1e3:.2f} M fp-mul/s")
            res[key] = {"lanes": STACK * b_lanes, "iters": iters,
                        "max_abs_err": err, "host_match": True, "ms": ms,
                        "plain_ms": plain_ms}
        if max_abs_err(outs["cuda"], outs["tc"]):
            raise RuntimeError("mont_chain: the two kernels differ")
        res["speedup"] = res["cuda"]["ms"] / res["tc"]["ms"]
        print(f"{label} speedup: {res['speedup']:.2f}x")
    if device.type == "cuda":
        from ..ops import _build

        counts = _build.sass_counts("mxu_redc")
        if counts is not None:
            n = _build.sass_count(counts, "mont_chain_tc_kernel", "IMMA")
            results["sass_imma"] = n
            print(f"sass mont_chain_tc_kernel: {n} x IMMA")
            if n < IMMA_PER_STEP:
                raise RuntimeError(f"mont_chain_tc_kernel: {n} IMMA in its "
                                   f"SASS, want at least {IMMA_PER_STEP}")
    return results


def main(argv=None) -> int:
    (batch, iters), device = parse_args(argv, "proto_mxu",
                                        [("B", 128), ("iters", 64)])
    run(batch, iters, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
