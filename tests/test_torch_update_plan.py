"""The launch plan of K3's update kernels (``sinkhorn_cuda.update_plan``),
which the wrapper computes on the host.  The one-cluster kernel
(``batch``): warp w of block k takes row k·rows_a_block + w, lane l the
columns l + 32·j, j < ``cols_per_lane``.  The other: block k of the grid takes
row k // splits and columns (k % splits)·cols .. of it, a thread a column
per pass, every block a column.  Either way every (row, column) of the
batch is one thread's, and the blocks are whole warps."""

import numpy as np
import pytest

from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

# (B, N): the filter's train and eval batches, a ragged and config 5's large N,
# a single particle, many rows of few particles, and one row or column past
# the one-block kernel
SHAPES = [(32, 100), (10, 100), (4, 4097), (4, 10240), (1, 1), (64, 5), (65, 100),
          (8, 257)]


@pytest.mark.parametrize("b,n", SHAPES)
def test_update_plan_covers_every_column_once(b, n):
    plan = sc.update_plan(b, n)
    threads = plan["threads"]
    seen = np.zeros((b, n), dtype=np.int64)
    if plan["batch"]:
        # the filter's batches: one block, or one cluster (a power of two of
        # at most 8 blocks, as a portable cluster takes), a warp a row
        assert b <= sc.UPDATE_BATCH_ROWS and n <= sc.UPDATE_BATCH_COLS
        blocks, rows, cpl = plan["blocks"], plan["rows_a_block"], plan["cols_per_lane"]
        assert plan["grid"] == blocks <= sc.UPDATE_CLUSTER and blocks & (blocks - 1) == 0
        assert threads == 32 * rows <= 512 and cpl in (1, 2, 4, 8) and 32 * cpl >= n
        assert blocks == 1 or rows <= sc.UPDATE_ONE_BLOCK_ROWS
        cols_l = (np.arange(32)[:, None] + 32 * np.arange(cpl)).ravel()
        for k in range(blocks):
            for w in range(rows):
                if k * rows + w < b:
                    seen[k * rows + w, cols_l[cols_l < n]] += 1
        assert (seen == 1).all(), plan
        return
    splits, cols = plan["splits"], plan["cols"]
    assert plan["grid"] == b * splits
    assert threads % 32 == 0 and 32 <= threads <= sc.UPDATE_THREADS
    for k in range(plan["grid"]):
        row, piece = divmod(k, splits)
        lo, hi = piece * cols, min(n, piece * cols + cols)
        assert lo < hi, (k, plan)
        for t in range(threads):
            seen[row, lo + t:hi:threads] += 1
    assert (seen == 1).all(), plan
    if n <= sc.UPDATE_THREADS:
        # one block a row of whole warps, a column a thread
        assert splits == 1 and n <= threads < n + 32
    else:
        # pieces of UPDATE_THREADS columns until the grid fills the card
        want = sc.UPDATE_BLOCKS_PER_SM * sc.H100_SMS
        assert plan["grid"] >= min(want, b * -(-n // sc.UPDATE_THREADS)), plan
        assert cols % 32 == 0 and threads == sc.UPDATE_THREADS, plan
