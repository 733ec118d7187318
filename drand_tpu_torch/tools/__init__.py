"""The card's own probes: the port of the JAX package's three TPU
measurement tools (``tools/microbench.py``, ``tools/proto_mxu.py`` and
``tools/proto_miller_grid.py``), each on hand-written CUDA kernels.

Run one as ``python -m drand_tpu_torch.tools.<name> [args] [--device
cpu]``; without ``--device cpu`` it runs on the card and raises where
there is none."""
