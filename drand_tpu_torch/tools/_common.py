"""What the three probes (and ``chip_smoke.py``) share: the device rule,
the command line, the clock and the error against a plain version."""

from __future__ import annotations

import argparse
import time

import torch


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) needs a card and raises without one; the CPU
    is taken only when the caller names it."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card; pass "
                           "--device cpu to run their plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name}")
    return dev


def parse_args(argv, prog: str, positional: list[tuple[str, int]]):
    """The JAX tool's positional integers (with its defaults) and
    ``--device``; returns (ints, device)."""
    p = argparse.ArgumentParser(prog=prog)
    for name, default in positional:
        p.add_argument(name, type=int, nargs="?", default=default)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    return ([getattr(args, name) for name, _ in positional],
            resolve_device(args.device))


def time_ms(fn, reps: int, device: torch.device | str = "cuda") -> float:
    """ms per call of ``fn``: on the card CUDA events around ``reps`` calls
    after one warm-up call; on the CPU the best of ``reps`` calls."""
    if torch.device(device).type == "cuda":
        fn()
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def time_once(fn, device: torch.device | str = "cuda"):
    """(fn(), ms of that one call): CUDA events on the card, the host clock
    on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int | float:
    """Largest |a - b|: an int for integer tensors, exact; a float for
    float tensors, in float64."""
    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max().item())
    return int((a.long() - b.long()).abs().max().item())
