"""ORDER BY / LIMIT with static shapes.

Counterpart of tidb_tpu/executor/sort.py. The JAX package sorts once with
``jax.lax.sort`` over several operands (lexicographic, False before
True). ``torch.sort`` takes one key, so the port sorts stably from the
last operand to the first: the result is the same lexicographic order.
Direction and MySQL null ordering (NULLs first ASC, last DESC) are key
transforms, as in the JAX package; invalid rows sink to the end.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from tidb_tpu_torch.chunk import Batch, DevCol

ExprFn = Callable[[Batch], DevCol]


def _directional_operands(batch: Batch, key_fns, descs) -> List[torch.Tensor]:
    """Ascending-sort operands implementing direction + null order."""
    ops: List[torch.Tensor] = [~batch.row_valid]
    for fn, desc in zip(key_fns, descs):
        k = fn(batch)
        valid = k.valid & batch.row_valid
        null_key = ~valid if desc else valid
        data = k.data
        if data.is_floating_point():
            dirdata = -data if desc else data
        elif data.dtype == torch.bool:
            dirdata = data ^ desc
        else:
            dirdata = -data.to(torch.int64) if desc else data
        ops.append(null_key)
        ops.append(torch.where(valid, dirdata, torch.zeros_like(dirdata)))
    return ops


def lex_permutation(operands: List[torch.Tensor]) -> torch.Tensor:
    """The permutation ``jax.lax.sort(operands, num_keys=len(operands))``
    gives, ties kept in row order: stable passes from the last operand to
    the first."""
    perm = torch.arange(operands[0].shape[0], dtype=torch.int64, device=operands[0].device)
    for op in reversed(operands):
        if op.dtype == torch.bool:
            op = op.to(torch.uint8)
        _vals, idx = torch.sort(op[perm], stable=True)
        perm = perm[idx]
    return perm


def sort_permutation(batch: Batch, key_fns, descs) -> torch.Tensor:
    """Row permutation that sorts the batch."""
    return lex_permutation(_directional_operands(batch, key_fns, descs))


def order_by(batch: Batch, key_fns, descs) -> Batch:
    """Fully sort the batch (valid rows first, in key order)."""
    perm = sort_permutation(batch, key_fns, descs)
    cols = {n: DevCol(c.data[perm], c.valid[perm]) for n, c in batch.cols.items()}
    return Batch(cols, batch.row_valid[perm])


def limit(batch: Batch, k: int, offset: int = 0) -> Batch:
    """Keep rows [offset, offset+k) in current row order (LimitExec)."""
    pos = torch.cumsum(batch.row_valid.to(torch.int64), 0) - 1
    keep = batch.row_valid & (pos >= offset) & (pos < offset + k)
    return Batch(batch.cols, keep)
