"""The Miller loop one iteration a launch, against K1's loop in one
thread: ``miller_step_kernel`` of ``csrc/pairing.cu``, its wrapper with a
launch counter, and its plain PyTorch version.

Counterpart of the JAX package's ``tools/proto_miller_grid.py`` (the
Pallas grid ``miller_grid`` over ``_miller_grid_kernel``), which ran the
Miller loop as a grid of ``N_MILLER`` = 63 steps with f and T carried in
VMEM scratch, to test whether the loop body was too large for the TPU
compiler's register allocation. Here ``miller_grid`` launches the step
kernel 63 times; f and T stay in device memory between launches, the host
passes each step's add flag from ``ops/pairing.MILLER_FLAGS``, and the
last step writes conj(f). The step runs K1's own ``miller_iteration``
(doubling step, addition step, line products), so the output equals K1's
word for word — the tool's own check — and ptxas's registers, stack and
spills of the one-iteration kernel stand beside K1's.

The inputs are the tool's: 8 messages signed with one key, broadcast over
B lanes, made with the port's ``crypto`` and packed by
``ops/pairing.pack_verify_inputs``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. On the card the tool runs at B and at the
catch-up bucket of 512.

Usage: python -m drand_tpu_torch.tools.proto_miller_grid [B] [--device cpu]
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from ..ops import field as fd
from ..ops import pairing as pp
from ..ops.limb import NWORDS, halves_to_words, words_to_halves
from ._common import max_abs_err, parse_args, time_ms

CATCHUP_BUCKET = 512
SK = 0x1F3A                      # the tool's key
N_MSGS = 8                       # the tool's messages, broadcast over B
_F12_SHAPE = (2, 3, 2, NWORDS)
_T_SHAPE = (2, 3, 2, NWORDS)     # pair, X/Y/Z, c0/c1

# Launch counts of the CUDA kernel (plain ints; counted where launched).
LAUNCHES = {"miller_step": 0}


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def miller_state_init(q: torch.Tensor):
    """The state before the first iteration, as words: f = 1 and T = Q
    with Z = 1 on both pairs."""
    b = q.shape[0]
    f = halves_to_words(fd.f12_one((b,), q.device))
    z = torch.zeros_like(q[:, :, 0])
    z[..., 0, :] = halves_to_words(fd.fp_one((), q.device))
    return f, torch.stack([q[:, :, 0], q[:, :, 1], z], dim=2).contiguous()


def miller_step_plain(f: torch.Tensor, t: torch.Tensor, xp: torch.Tensor,
                      yp: torch.Tensor, q: torch.Tensor, add: bool):
    """One Miller iteration on a state saved as words (f (B, 2, 3, 2, 12),
    T (B, 2, 3, 2, 12)): ``ops/pairing``'s doubling and addition steps and
    line products, as K1 runs them -> the next state as words."""
    px, py = words_to_halves(xp), words_to_halves(yp)
    qh = words_to_halves(q)
    xq, yq = qh[:, :, 0], qh[:, :, 1]
    th = words_to_halves(t)
    T = (th[:, :, 0], th[:, :, 1], th[:, :, 2])
    fh = fd.f12_sqr(words_to_halves(f))
    T, lines = pp._dbl_step(T, px, py)
    fh = fd.f12_mul(fh, pp._lines_product(lines))
    if add:
        T, lines = pp._add_step(T, xq, yq, px, py)
        fh = fd.f12_mul(fh, pp._lines_product(lines))
    return halves_to_words(fh), halves_to_words(torch.stack(T, dim=2))


def miller_grid_plain(xp: torch.Tensor, yp: torch.Tensor,
                      q: torch.Tensor) -> torch.Tensor:
    """Plain version of the 63 steps: conj(f), as ``miller_loop_plain``."""
    f, t = miller_state_init(q)
    for i in range(pp.N_MILLER):
        f, t = miller_step_plain(f, t, xp, yp, q, bool(pp.MILLER_FLAGS[i]))
    return halves_to_words(fd.f12_conj(words_to_halves(f)))


# ---------------------------------------------------------------------------
# Wrapper: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def miller_grid(xp: torch.Tensor, yp: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """The Miller loop of B two-pair checks, one launch an iteration ->
    conj(f) (B, 2, 3, 2, 12), K1's output."""
    b = xp.shape[0]
    for name, x, shape in (("xp", xp, (b, 2, NWORDS)),
                           ("yp", yp, (b, 2, NWORDS)),
                           ("q", q, (b, 2, 2, 2, NWORDS))):
        pp._check(name, x, shape, xp.device)
    if xp.device.type == "cpu":
        return miller_grid_plain(xp, yp, q)
    if xp.device.type != "cuda":
        raise ValueError(f"miller_grid: unsupported device {xp.device}")
    from ..ops import _build

    out = torch.empty((b,) + _F12_SHAPE, dtype=torch.int32, device=xp.device)
    if b == 0:
        return out
    f_state = torch.empty_like(out)
    t_state = torch.empty((b,) + _T_SHAPE, dtype=torch.int32,
                          device=xp.device)
    consts = pp._consts_on(xp.device)
    lib = _build.library("pairing")
    stream = ctypes.c_void_p(torch.cuda.current_stream(xp.device).cuda_stream)
    ptrs = [pp._ptr(x) for x in (consts, xp, yp, q, f_state, t_state, out)]
    for i in range(pp.N_MILLER):
        err = lib.miller_step_launch(
            ptrs[0], consts.numel(), *ptrs[1:], b, int(i == 0),
            int(pp.MILLER_FLAGS[i]), int(i == pp.N_MILLER - 1), stream)
        pp._raise_on(err, f"miller_step_kernel (step {i})")
        LAUNCHES["miller_step"] += 1
    return out


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _tool_points() -> tuple:
    """The public key and the 8 signatures and message points as words,
    signed on the host once a process."""
    from ..crypto import bls
    from ..crypto.curves import PointG1, PointG2
    from ..crypto.hash_to_curve import hash_to_g2
    from ..ops.engine import _g1_xy, _g2_xy

    pub = _g1_xy(PointG1.generator().mul(SK).to_affine())
    sigs, msgs = [], []
    for i in range(N_MSGS):
        m = b"bench-%d" % i
        msgs.append(_g2_xy(hash_to_g2(m).to_affine()))
        sigs.append(_g2_xy(PointG2.from_bytes(
            bls.sign(SK, m), subgroup_check=False).to_affine()))
    return pub, sigs, msgs


def tool_inputs(batch: int, device) -> tuple:
    """The tool's inputs: 8 messages signed with ``SK``, broadcast over
    ``batch`` lanes, packed as K1 takes them (xp, yp, q)."""
    pub, sigs, msgs = _tool_points()
    pubs = np.broadcast_to(pub, (batch,) + pub.shape)
    sig = np.stack([sigs[i % N_MSGS] for i in range(batch)])
    msg = np.stack([msgs[i % N_MSGS] for i in range(batch)])
    return pp.pack_verify_inputs(*(torch.from_numpy(np.ascontiguousarray(a))
                                   .to(device) for a in (pubs, sig, msg)))


def ptxas_rows() -> dict:
    """ptxas's registers, stack and spills of K1 and the step kernel, from
    the build of ``csrc/pairing.cu`` (empty before a build)."""
    from ..ops import _build

    info = _build.info("pairing")
    out = {}
    for mangled, props in (info or {}).get("kernels", {}).items():
        for short in ("miller_loop_kernel", "miller_step_kernel"):
            if short in mangled:
                out[short] = props
    return out


def run(batch: int = 128, device: torch.device | str = "cuda",
        reps: int = 5) -> dict:
    """The 63-step grid against K1 (word for word, raises on a mismatch)
    and both timed, at ``batch`` lanes and, on the card, also at the
    catch-up bucket; returns {B: record}."""
    device = torch.device(device)
    sizes = [batch]
    if device.type == "cuda" and batch != CATCHUP_BUCKET:
        sizes.append(CATCHUP_BUCKET)
    results = {}
    for b in sizes:
        xp, yp, q = tool_inputs(b, device)
        grid = miller_grid(xp, yp, q)
        k1 = pp.miller_loop(xp, yp, q)
        err = max_abs_err(grid, k1)
        print(f"B={b}: outputs identical: {err == 0}")
        if err:
            raise RuntimeError(f"miller_grid differs from K1 by {err} at "
                               f"B={b}")
        rec = results[b] = {
            "max_abs_err": err,
            "grid_ms": time_ms(lambda: miller_grid(xp, yp, q), reps, device),
            "k1_ms": time_ms(lambda: pp.miller_loop(xp, yp, q), reps,
                             device)}
        print(f"old (K1): {rec['k1_ms']:.2f} ms/call @ B={b}")
        print(f"grid: {rec['grid_ms']:.2f} ms/call @ B={b} "
              f"({pp.N_MILLER} launches)")
    for name, props in ptxas_rows().items():
        print(f"ptxas {name}: {props.get('registers')} registers, "
              f"{props.get('stack_bytes')} bytes stack, "
              f"{props.get('spill_store_bytes')}/"
              f"{props.get('spill_load_bytes')} bytes spill stores/loads")
    return results


def main(argv=None) -> int:
    (batch,), device = parse_args(argv, "proto_miller_grid", [("B", 128)])
    run(batch, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
