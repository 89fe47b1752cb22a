"""The launch plans of the context kernels (``coupling_cuda.ctx_share_plan``,
``ctx_weight_grad_plan`` and ``ctx_input_grad_plan``), which the wrapper
computes on the host: for every chain that ``chain_refusal`` accepts, at the
row counts the filter and the smoke run, each context row and each row of
g1 falls in exactly one block, each context entry in exactly one tile, each
entry of the context's gradient in exactly one thread, and the shared
memory and threads fit an H100 block.  The weight gradient's parts (its first
kernel's plain version on the plan), weighed and added in part order as
its second kernel does, give the plain version of the whole gradient."""

import numpy as np
import pytest
import torch

from nfdpf_torch.ops.cuda import coupling_cuda as cc

# (B, N) of the filter's train and eval batches and of a large ragged one
ROW_SHAPES = [(32, 100), (10, 100), (4, 4097)]
CTX_DIMS = (1, 4, 36, 196, 197, 1000)


def _accepted_chains():
    """(blocks, hidden) of every chain K4 and K5 take on the card."""
    out = []
    for hidden in range(1, cc.MAX_HIDDEN + 1):
        for n_blocks in range(1, cc.MAX_BLOCKS + 1):
            if all(cc.chain_refusal(n_blocks, hidden, 36, 100, True, bwd) is None
                   for bwd in (False, True)):
                out.append((n_blocks, hidden))
    return out


def _covers(total, per_block, blocks):
    """Blocks of ``per_block`` from 0 on cover [0, total) once each."""
    starts = np.arange(blocks) * per_block
    return bool(per_block >= 1 and starts[-1] < total <= starts[-1] + per_block)


@pytest.mark.parametrize("b,n", ROW_SHAPES)
def test_ctx_weight_grad_plan_covers_every_row_once(b, n):
    chains = _accepted_chains()
    assert (8, 8) in chains and (3, 16) in chains and (4, 16) not in chains
    rows = b * n
    for n_blocks, hidden in chains:
        ps = 4 * n_blocks * cc.kernel_hidden(hidden)
        for ctx_dim in CTX_DIMS:
            for mode in (cc.PER_BATCH, cc.PER_ROW):
                plan = cc.ctx_weight_grad_plan(rows, n, mode, ctx_dim, ps)
                rpb, parts, (g1x, g1y) = plan["rows_per_block"], plan["parts"], plan["grid1"]
                where = (n_blocks, hidden, ctx_dim, mode, plan)
                assert plan["segments"] == (mode == cc.PER_BATCH and n >= cc.CTX_SEGMENT_MIN_N)
                assert g1x == parts, where
                if plan["segments"]:
                    # the pieces of each context row's n rows, then the next row
                    assert _covers(n, rpb, plan["pieces"]) and parts == b * plan["pieces"]
                    assert g1y == -(-(ps // 4) // cc.CTX_COLUMN_LANES), where
                    assert plan["part_floats"] == parts * ps, where
                else:
                    assert _covers(rows, rpb, parts) and plan["pieces"] == 1, where
                    assert _covers(ctx_dim, plan["c_tile1"], g1y), where
                    # a thread takes 4 entries x 4 columns: a group fits 256 threads
                    assert -(-plan["c_tile1"] // 4) * (ps // 4) <= cc.CTX_THREADS, where
                    assert plan["part_floats"] == parts * ctx_dim * ps, where
                assert plan["grid2"] == ctx_dim and ps // 4 <= cc.CTX_THREADS, where
                assert max(plan["smem_bytes1"], plan["smem_bytes2"]) <= cc.MAX_SMEM_BYTES, where


@pytest.mark.parametrize("b,n", ROW_SHAPES)
def test_ctx_input_grad_plan_covers_every_entry_once(b, n):
    """gctx (B·N x C) in tiles of ``tile_rows`` x ``tile_cols`` (one of
    ``CTX_IN_TILES``, which the kernel library instantiates): a thread
    stores rows ty + (tile_rows / TM)·i (i < TM, its ``rows_a_thread``) and
    entries tx + ``CTX_IN_LANES``·jj of its tile, so every (row, entry) is one
    thread's, and the k of g1's rows come in ``chunks`` stages; at most
    1,024 threads and 48 KB of static shared memory a block (within an
    H100 block's 227 KB)."""
    rows = b * n
    for n_blocks, hidden in _accepted_chains():
        ps = 4 * n_blocks * cc.kernel_hidden(hidden)
        for ctx_dim in CTX_DIMS + (16, 17, 63, 64, 65):
            plan = cc.ctx_input_grad_plan(rows, ctx_dim, ps)
            tr, tc, tm = (plan[k] for k in ("tile_rows", "tile_cols", "rows_a_thread"))
            lanes = cc.CTX_IN_LANES
            where = (n_blocks, hidden, ctx_dim, plan)
            ty, gx, gy = tr // tm, *plan["grid"]
            local_rows = (np.arange(ty)[:, None] + ty * np.arange(tm)).ravel()
            local_cols = (np.arange(lanes)[:, None] + lanes * np.arange(tc // lanes)).ravel()
            r = (np.arange(gx)[:, None] * tr + local_rows).ravel()
            c = (np.arange(gy)[:, None] * tc + local_cols).ravel()
            assert np.array_equal(np.sort(r[r < rows]), np.arange(rows)), where
            assert np.array_equal(np.sort(c[c < ctx_dim]), np.arange(ctx_dim)), where
            assert (ty, tm, tc // lanes) in cc.CTX_IN_TILES, where
            assert tc % lanes == 0, where
            assert plan["threads"] == ty * lanes <= 1024, where
            assert plan["smem_bytes"] == cc.ctx_input_grad_smem_bytes(tr, tc), where
            # a context at most CTX_IN_NARROW wide in one tile
            assert ctx_dim > cc.CTX_IN_NARROW or gy == 1, where
            chunk = cc.CTX_IN_CHUNK
            assert (plan["chunks"] - 1) * chunk < ps <= plan["chunks"] * chunk, where
            assert ps % 4 == 0 and chunk % 4 == 0, where    # 16-byte stages of g1's rows
            assert plan["smem_bytes"] <= min(48 * 1024, cc.MAX_SMEM_BYTES), where


@pytest.mark.parametrize("b,n", ROW_SHAPES)
def test_ctx_share_plan_covers_every_context_row_once(b, n):
    for n_blocks, hidden in _accepted_chains():
        h = cc.kernel_hidden(hidden)
        nets = 4 * n_blocks
        for ctx_dim in (0,) + CTX_DIMS:
            for r in (b, b * n):
                plan = cc.ctx_share_plan(r, n_blocks, h, ctx_dim)
                rows, nets_a, rpt = (plan["rows_a_block"], plan["nets_a_block"],
                                     plan["rows_a_thread"])
                where = (n_blocks, hidden, ctx_dim, r, plan)
                assert _covers(r, rows, plan["grid"][0]), where
                assert nets % nets_a == 0 and plan["grid"][1] == nets // nets_a, where
                assert rpt in (1, 16) and rows % rpt == 0, where
                assert plan["threads"] == rows // rpt * nets_a * h <= 512, where
                assert plan["c_chunk"] <= ctx_dim, where
                assert (plan["c_chunk"] == 0) == (ctx_dim <= cc.CTX_SHARE_DIRECT), where
                assert plan["smem_bytes"] <= cc.CTX_SHARE_SMEM_BYTES, where


@pytest.mark.parametrize("b,n,ctx_dim,broadcast,n_blocks,hidden", [
    (32, 100, 196, True, 2, 8), (4, 4097, 36, False, 2, 8), (3, 33, 5, True, 8, 8),
    (64, 5, 36, True, 3, 16), (3, 1037, 197, False, 1, 3), (2, 600, 7, True, 2, 8)])
def test_ctx_grad_rows_parts_sum_to_the_plain_version(b, n, ctx_dim, broadcast, n_blocks,
                                                      hidden):
    """The weight gradient's first kernel's plain version on its plan: the
    parts, weighed by their context row (segments: part j of context row
    j // pieces) or added as they are (rows), in part order, give the plain
    version of the whole gradient (float64, to 1e-12 of its scale), the
    context broadcast over the particles or dense."""
    rng = np.random.default_rng(b + n + ctx_dim)
    rows, ps = b * n, 4 * n_blocks * hidden
    g1 = torch.tensor(rng.standard_normal((rows, ps)))
    ctx = torch.tensor(rng.standard_normal((b, 1 if broadcast else n, ctx_dim)))
    ctx = ctx.expand(b, n, ctx_dim)
    w = torch.zeros(n_blocks, 4, 3, max(1 + ctx_dim, hidden), hidden, dtype=torch.float64)
    mode, _ = cc.context_layout(ctx)
    plan = cc.ctx_weight_grad_plan(rows, n, mode, ctx_dim, ps)
    parts = cc.ctx_grad_rows(g1, ctx, w)             # on the CPU: the plain version
    got = torch.zeros(ctx_dim, ps, dtype=torch.float64)
    for j in range(plan["parts"]):
        got += (torch.outer(ctx[j // plan["pieces"], 0], parts[j]) if plan["segments"]
                else parts[j])
    ref = cc.ctx_weight_grad_plain(g1, ctx, w).permute(2, 0, 1, 3).reshape(ctx_dim, ps)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))
