"""The port's Fp element format and its host-side packing.

An Fp element crosses every public boundary of the port (kernel wrappers,
plain versions, engine packing) as **12 little-endian 32-bit words of the
canonical Montgomery value** ``a·R mod p`` with ``R = 2^384``, stored as
``torch.int32`` bit patterns, shape ``(..., 12)``. R is the JAX package's
Montgomery radix too, so a value is the same integer mod p in both
packages; only the limb split differs (the JAX package keeps 32 lazily
reduced 12-bit limbs, a TPU artefact — see ``ops/convert.py``).

Inside the plain PyTorch arithmetic (``ops/field.py``) an element is 24
little-endian 16-bit half-words in int64, so that every limb product and
every column sum of a schoolbook product stays exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.fields import P

NWORDS = 12               # 32-bit words per Fp element (public format)
NHALF = 24                # 16-bit half-words per element (plain arithmetic)
HMASK = 0xFFFF
R_MONT = 1 << 384
R_INV = pow(R_MONT, -1, P)
ONE_MONT = R_MONT % P     # Montgomery form of 1
N0_WORD = (-pow(P, -1, 1 << 32)) % (1 << 32)   # -p^-1 mod 2^32 (CIOS)


def to_mont(x: int) -> int:
    return x * R_MONT % P


def from_mont(x: int) -> int:
    return x * R_INV % P


def int_to_words(x: int, n: int = NWORDS) -> np.ndarray:
    """Non-negative int < 2^(32n) -> (n,) int32 words (two's-complement
    bit patterns of the unsigned words)."""
    if x < 0 or x >> (32 * n):
        raise ValueError("value does not fit")
    u = np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)],
                 dtype=np.uint32)
    return u.view(np.int32)


def words_to_int(w) -> int:
    """(n,) words (any int dtype, read as unsigned 32-bit) -> int."""
    u = np.asarray(w).astype(np.int64) & 0xFFFFFFFF
    return sum(int(v) << (32 * i) for i, v in enumerate(u.tolist()))


def fp_words(x: int) -> np.ndarray:
    """Host int -> Montgomery words."""
    return int_to_words(to_mont(x % P))


def fp_from_words(w) -> int:
    """Montgomery words -> canonical host int."""
    return from_mont(words_to_int(w))


def pack_ints(values, shape=()) -> torch.Tensor:
    """Nested host ints (canonical, NOT Montgomery) -> int32 tensor of
    shape ``shape + (12,)`` in the port's public format."""
    flat = np.asarray(values, dtype=object).reshape(-1)
    out = np.stack([fp_words(int(v)) for v in flat]) if flat.size else \
        np.zeros((0, NWORDS), np.int32)
    return torch.from_numpy(out.reshape(tuple(shape) + (NWORDS,)))


def unpack_ints(t: torch.Tensor) -> np.ndarray:
    """int32 tensor ``(..., 12)`` -> object array of canonical host ints."""
    a = t.detach().cpu().numpy()
    flat = a.reshape(-1, NWORDS)
    out = np.array([fp_from_words(r) for r in flat], dtype=object)
    return out.reshape(a.shape[:-1])


# ---------------------------------------------------------------------------
# word <-> half-word (torch; device-agnostic)
# ---------------------------------------------------------------------------

def words_to_halves(w: torch.Tensor) -> torch.Tensor:
    """(..., 12) int32 words -> (..., 24) int64 half-words."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & HMASK, u >> 16], dim=-1).flatten(-2)


def halves_to_words(h: torch.Tensor) -> torch.Tensor:
    """(..., 24) int64 half-words in [0, 2^16) -> (..., 12) int32 words."""
    h2 = h.unflatten(-1, (NWORDS, 2))
    u = h2[..., 0] | (h2[..., 1] << 16)
    # reinterpret the unsigned 32-bit value as an int32 bit pattern
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def int_to_halves(x: int, n: int = NHALF) -> list[int]:
    return [(x >> (16 * i)) & HMASK for i in range(n)]
