"""The wire path on the card: the two kernels of ``csrc/h2c.cu``, their
wrappers with launch counters, and the launch sequences that verify or
combine a bucket of wire checks.

Counterpart of the JAX package's ``ops/pallas_wire.py``:

- ``hash_to_g2`` (K5) replaces, fused, ``_map_kernel`` (×2),
  ``_ptadd_affine_kernel``, ``_mulx_kernel`` (×2) and
  ``_clear_glue_kernel`` — the chain of ``_hash_msgs_pl``;
- ``decompress_g2`` (K6) replaces ``_sig_kernel`` (``_sig_pl``);
- ``verify_wire_prepared`` is ``_wire_verify_pl``: K6, K5, then K1 and
  K2 of ``ops/pairing.py``, verdict ``pair_ok & sig_ok & ~minf``;
- ``wire_rlc_combine`` is ``_wire_rlc_pl``: K6, K5, then two G2 MSMs
  (``ops/msm.py``) at 128-bit scalars over the lanes that decoded, hashed
  to a finite point and are live.

A wrapper given CPU tensors runs the kernel's plain version
(``ops/h2c.py``); given CUDA tensors it launches the kernel or raises.

Layouts (int32 words of canonical Montgomery values, ``ops/limb.py``):

    u      (n, 2, 2, 12)   two Fp2 u-values per message (``msgs_to_u``)
    x      (n, 2, 12)      signature x-coordinates (``sigs_to_x``)
    sign   (n,)            int32 sort flags
    xy     (n, 2, 2, 12)   affine x / y; zeros on rejected lanes
    inf    (n,)            int32, 1 iff the hashed point is infinity
    ok     (n,)            int32, 1 iff the signature is on E2 and in G2
"""

from __future__ import annotations

import ctypes

import torch

from . import msm as msm_ops
from . import pairing
from .h2c import decompress_plain, h2c_consts, hash_to_g2_plain
from .limb import NWORDS
from .pairing import _check, _consts_on, _ptr, _raise_on

# Launch counts of the CUDA kernels (plain ints; counted where launched).
LAUNCHES = {"hash_to_g2": 0, "decompress_g2": 0}

_HCONSTS_DEV: dict[str, torch.Tensor] = {}


def _hconsts_on(device) -> torch.Tensor:
    key = str(device)
    t = _HCONSTS_DEV.get(key)
    if t is None:
        t = torch.from_numpy(h2c_consts()).to(device)
        _HCONSTS_DEV[key] = t
    return t


def _lib():
    from . import _build

    return _build.library("h2c")


def hash_to_g2(u: torch.Tensor):
    """K5: u (n, 2, 2, 12) -> (xy (n, 2, 2, 12), inf (n,) int32)."""
    n = u.shape[0]
    if n < 1:
        raise ValueError("hash_to_g2: needs n >= 1 lanes")
    _check("u", u, (n, 2, 2, NWORDS), u.device)
    if u.device.type == "cpu":
        return hash_to_g2_plain(u)
    if u.device.type != "cuda":
        raise ValueError(f"hash_to_g2: unsupported device {u.device}")
    xy = torch.empty((n, 2, 2, NWORDS), dtype=torch.int32, device=u.device)
    inf = torch.empty((n,), dtype=torch.int32, device=u.device)
    consts, hconsts = _consts_on(u.device), _hconsts_on(u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _lib().hash_to_g2_launch(_ptr(consts), consts.numel(),
                                   _ptr(hconsts), hconsts.numel(), _ptr(u),
                                   _ptr(xy), _ptr(inf), n,
                                   ctypes.c_void_p(stream))
    _raise_on(err, "hash_to_g2_kernel")
    LAUNCHES["hash_to_g2"] += 1
    return xy, inf


def decompress_g2(x: torch.Tensor, sign: torch.Tensor):
    """K6: x (n, 2, 12), sign (n,) -> (xy (n, 2, 2, 12), ok (n,) int32)."""
    n = x.shape[0]
    if n < 1:
        raise ValueError("decompress_g2: needs n >= 1 lanes")
    _check("x", x, (n, 2, NWORDS), x.device)
    _check("sign", sign, (n,), x.device)
    if x.device.type == "cpu":
        return decompress_plain(x, sign)
    if x.device.type != "cuda":
        raise ValueError(f"decompress_g2: unsupported device {x.device}")
    xy = torch.empty((n, 2, 2, NWORDS), dtype=torch.int32, device=x.device)
    ok = torch.empty((n,), dtype=torch.int32, device=x.device)
    consts, hconsts = _consts_on(x.device), _hconsts_on(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().decompress_g2_launch(_ptr(consts), consts.numel(),
                                      _ptr(hconsts), hconsts.numel(),
                                      _ptr(x), _ptr(sign), _ptr(xy), _ptr(ok),
                                      n, ctypes.c_void_p(stream))
    _raise_on(err, "decompress_g2_kernel")
    LAUNCHES["decompress_g2"] += 1
    return xy, ok


def verify_wire_prepared(pub_xy: torch.Tensor, u: torch.Tensor,
                         x: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """(b,) bool per lane: decompress the signatures (K6), hash the
    messages (K5), check e(−g1, σ)·e(pub, H(m)) == 1 (K1, K2) under one
    public key ``pub_xy`` (2, 12); a lane passes only if its signature
    decoded into G2 and its message hashed to a finite point."""
    sig_xy, sig_ok = decompress_g2(x, sign)
    msg_xy, msg_inf = hash_to_g2(u)
    pubs = pub_xy.expand(u.shape[0], 2, NWORDS).contiguous()
    pair_ok = pairing.verify_prepared(pubs, sig_xy, msg_xy)
    return pair_ok & (sig_ok != 0) & (msg_inf == 0)


def wire_rlc_combine(u: torch.Tensor, x: torch.Tensor, sign: torch.Tensor,
                     live: torch.Tensor, bits: torch.Tensor):
    """The wire-RLC combine of one bucket: K6 and K5, then (Σcᵢσᵢ, ΣcᵢH(mᵢ))
    by two MSM launches sharing the scalar bits (b, 128). A lane that
    failed decoding, hashed to infinity or is not ``live`` is masked out
    of both sums. Returns (ok (b,) bool, (sig xy, sig inf), (msg xy, msg
    inf))."""
    sig_xy, sig_ok = decompress_g2(x, sign)
    msg_xy, msg_inf = hash_to_g2(u)
    ok = (sig_ok != 0) & (live != 0) & (msg_inf == 0)
    dead = (~ok).to(torch.int32)
    if u.device.type == "cpu":
        # the plain version of the two MSM launches, as one stacked call
        xy, inf = msm_ops.msm_plain(torch.stack([sig_xy, msg_xy]), dead, bits)
        return ok, (xy[0], inf[0]), (xy[1], inf[1])
    return (ok, msm_ops.msm(sig_xy, dead, bits),
            msm_ops.msm(msg_xy, dead, bits))
