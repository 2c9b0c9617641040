"""tidb_tpu_torch — the PyTorch/CUDA port of tidb_tpu.

The same SQL goes in and the same rows come out as in the JAX package
``tidb_tpu``, which stays beside it as the reference. Plain tensor code is
torch; the JAX package's Pallas TPU kernels are CUDA kernels written by
hand for Hopper (``csrc/``, built by ``_build``). The port imports
neither JAX nor ``tidb_tpu``: it keeps its own copy of every module it
needs. Entry points run on CUDA unless the caller passes
``device="cpu"``.

Ported so far: ``Session.execute`` for a SELECT with WHERE, joins,
GROUP BY, aggregates, windows, set operations and ORDER BY/LIMIT (all 22
TPC-H queries, TPC-DS Q95), ANALYZE TABLE, and streamed (spill)
aggregation for inputs past one device tile (TPC-H SF100).
"""

__version__ = "0.1.0"
