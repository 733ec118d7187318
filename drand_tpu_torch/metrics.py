"""Device pairing meters of the port's engine.

The same meters, with the same counting rule, as the JAX engine's
``N_PRODUCT_CHECKS``/``N_MILLER_PAIRS`` (``drand_tpu/ops/engine.py:83-108``):
every public verify call of ``BatchedEngine`` counts ONE product check and
two Miller pairs per requested row, however many bucket launches it
takes. Known-answer probes go through the engine's internal launcher and
are not counted. Plain ints, read and compared by tests and the chip
smoke.
"""

from __future__ import annotations

N_PRODUCT_CHECKS = 0   # public verify dispatches
N_MILLER_PAIRS = 0     # 2 x requested rows across those dispatches


def meter_rows(n: int) -> None:
    """Count one public verify dispatch of n two-pair rows."""
    global N_PRODUCT_CHECKS, N_MILLER_PAIRS
    N_PRODUCT_CHECKS += 1
    N_MILLER_PAIRS += 2 * n
