"""The launch plans of the context kernels (``coupling_cuda.ctx_share_plan``,
``ctx_weight_grad_plan`` and ``ctx_input_grad_plan``), which the wrapper
computes on the host: for every chain that the narrow pair takes, at the
row counts the filter and the smoke run, each context row and each row of
g1 falls in exactly one block, each context entry in exactly one tile, each
entry of the context's gradient in exactly one thread, and the shared
memory and threads fit an H100 block.  The weight gradient's parts (its first
kernel's plain version on the plan), weighed and added in part order as
its second kernel does, give the plain version of the whole gradient.  The
same for the wide pair's chains, up to hidden 256 and 12 blocks (the weight
gradient in column groups of g1), and the wide pair's own plans
(``wide_fwd_plan``, ``wide_bwd_plan``) and shared-memory mirrors at every
width up to 1,024."""

import numpy as np
import pytest
import torch

from nfdpf_torch.ops.cuda import coupling_cuda as cc

# (B, N) of the filter's train and eval batches and of a large ragged one
ROW_SHAPES = [(32, 100), (10, 100), (4, 4097)]
CTX_DIMS = (1, 4, 36, 196, 197, 1000)


def _accepted_chains():
    """(blocks, hidden) of every chain the narrow pair (K4 and K5 of one
    width) takes on the card."""
    return [(n_blocks, hidden) for hidden in range(1, cc.MAX_HIDDEN + 1)
            for n_blocks in range(1, cc.MAX_BLOCKS + 1)
            if cc.narrow_pair_takes(n_blocks, hidden)]


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


# chains only the wide pair takes, as (blocks, hidden): the cases the card
# runs (chip_smoke.py's WIDE_CHAINS), odd widths whose whole warps would pass
# a share block, and 12 blocks at widths from 17 to 256
WIDE_CHAINS = sorted({(4, 12), (2, 17), (4, 32), (9, 32), (12, 64), (2, 256), (9, 12),
                      (3, 33), (1, 300), (1, 1024)}
                     | {(12, h) for h in (17, 31, 33, 48, 64, 100, 128, 200, 255, 256)})


def test_wide_chains_are_the_ones_the_narrow_pair_leaves():
    """Every chain is the narrow pair's or the wide pair's, and none is
    refused up to ``WIDE_MAX_HIDDEN``; the narrow pair keeps (3, 16) and
    leaves (4, 16), (1, 17) and (9, 8)."""
    assert (3, 16) in _accepted_chains() and (8, 8) in _accepted_chains()
    for n_blocks, hidden in ((4, 16), (1, 17), (9, 8)) + tuple(WIDE_CHAINS):
        assert not cc.narrow_pair_takes(n_blocks, hidden), (n_blocks, hidden)
    for hidden in (1, 16, 17, 256, cc.WIDE_MAX_HIDDEN):
        assert cc.chain_refusal(hidden) is None
    assert "1024" in cc.chain_refusal(cc.WIDE_MAX_HIDDEN + 1)


def _wide_smem_floats(hidden, tile_rows, tc, tn, kc, backward):
    """The wide block's shared memory in floats, written out from its layout
    (``wide_smem_floats`` in ``csrc/coupling.cu``): the ring's 3 chunks of
    kc rows of hp + 4 floats and 3 slots of the vector ring (three vectors
    of hp, layer 2's bias in 4, the tile's rows of P where they take at most
    2,048 floats), the tile's h1 (and the backward's g2) in rows
    reaching past every unit a thread holds and every row of W1 the weight
    gradient's passes of ``tile_rows`` take, the row sums a warp, each row's
    half and row of P (and output gradient), the backward's four sums a
    row group and unit."""
    hp = tc * tn
    reach = max(hp, -(-hidden // tile_rows) * tile_rows)
    ldt = -(-reach // 4) * 4 + 4
    rows_p = tile_rows * (-(-hidden // 4) * 4)
    vec = 3 * hp + 4 + (rows_p if rows_p <= 2048 else 0)
    floats = 3 * (kc * (hp + 4) + vec) + tile_rows * ldt + tile_rows * (tc // 32) + 2 * tile_rows
    if backward:
        floats += tile_rows * ldt + 4 * (256 // tc) * hp + tile_rows
    return floats


@pytest.mark.parametrize("b,n", ROW_SHAPES)
def test_wide_plans_cover_every_row_once_and_fit_a_block(b, n):
    """The wide pair's plans at every hidden width 17-1,024 (and the wide
    chains' narrower ones) and 1, 2, 4, 9 and 12 blocks: tiles of
    (256 / TC)·TM rows cover the rows once; TC a multiple of 32 that
    divides the block, TC·TN units at least H, the shape the width's entry
    of ``WIDE_FWD_TILES`` / ``WIDE_BWD_TILES``; the ring's chunks a power of
    two no larger than H needs, the largest of ``WIDE_CHUNKS`` that fits;
    the shared memory the mirror's, the layout's and within a block's; the
    backward's grid at most one block a tile, its partials within
    ``WIDE_PART_BYTES`` (a block's own beyond it), 2K + 1 states a row."""
    rows = b * n
    widths = sorted(set(range(17, cc.WIDE_MAX_HIDDEN + 1)) | {h for _, h in WIDE_CHAINS})
    for hidden in widths:
        assert cc.wide_part_floats(hidden) == hidden * hidden + 4 * hidden + 1
        for backward, tiles in ((False, cc.WIDE_FWD_TILES), (True, cc.WIDE_BWD_TILES)):
            shape = next(t[1:] for t in tiles if hidden <= t[0])
            for n_blocks in (1, 2, 4, 9, 12):
                plan = (cc.wide_bwd_plan(rows, n_blocks, hidden) if backward
                        else cc.wide_fwd_plan(rows, hidden))
                tile, tc, tn, kc = plan["tile_rows"], plan["tc"], plan["tn"], plan["kc"]
                where = (n_blocks, hidden, backward, plan)
                assert (plan["tm"], tn, tc) == shape, where
                assert tc % 32 == 0 and 256 % tc == 0 and plan["threads"] == 256, where
                assert tile == 256 // tc * plan["tm"] <= 64 and tc * tn >= hidden, where
                assert _covers(rows, tile, plan["tiles"]), where
                most = 1 << max(2, (-(-hidden // 4) * 4 - 1).bit_length())
                assert kc in cc.WIDE_CHUNKS and kc <= most, where
                bigger = [k for k in cc.WIDE_CHUNKS if kc < k <= most]
                assert all(cc.wide_smem_bytes(hidden, tile, tc, tn, k, backward)
                           > cc.MAX_SMEM_BYTES for k in bigger), where
                assert plan["smem_bytes"] == cc.wide_smem_bytes(hidden, tile, tc, tn, kc,
                                                                backward), where
                assert plan["smem_bytes"] == 4 * _wide_smem_floats(hidden, tile, tc, tn, kc,
                                                                   backward), where
                assert plan["smem_bytes"] <= cc.MAX_SMEM_BYTES, where
                if backward:
                    assert 1 <= plan["grid"] <= plan["tiles"], where
                    per_block = 4 * n_blocks * cc.wide_part_floats(hidden)
                    assert plan["part_floats"] == plan["grid"] * per_block, where
                    assert 4 * plan["part_floats"] <= max(cc.WIDE_PART_BYTES, 4 * per_block), where
                    assert plan["state_floats"] == rows * 2 * (2 * n_blocks + 1), where
                else:
                    assert plan["grid"] == plan["tiles"], where
    # the filter's rows at hidden 256, two blocks: a block a tile of 32 rows,
    # 100 partials of 2.1 MB (the earlier design's 120 took 255 MB)
    plan = cc.wide_bwd_plan(3200, 2, 256)
    assert (plan["tile_rows"], plan["grid"]) == (32, 100)
    assert 4 * plan["part_floats"] <= 215e6


@pytest.mark.parametrize("b,n", ROW_SHAPES)
def test_ctx_plans_take_the_wide_chains(b, n):
    """The context kernels on the wide library at the wide chains' widths:
    a share block's threads (a thread a hidden unit of its nets) at most
    1,024, its rows covered; the weight gradient's column groups of g1
    (``ctx_grad_groups``: widths multiples of 4, at most
    ``CTX_GRAD_COLUMNS``) cover 4K·H once, each a plan its kernels take;
    the input gradient's tiles cover the context's gradient."""
    rows = b * n
    for n_blocks, hidden in WIDE_CHAINS:
        ps = 4 * n_blocks * hidden
        for ctx_dim in (0, 4, 36, 196):
            for r in (b, rows):
                plan = cc.ctx_share_plan(r, n_blocks, hidden, ctx_dim)
                where = (n_blocks, hidden, ctx_dim, r, plan)
                assert _covers(r, plan["rows_a_block"], plan["grid"][0]), where
                assert plan["threads"] == (plan["rows_a_block"] // plan["rows_a_thread"]
                                           * plan["nets_a_block"] * hidden) <= 1024, where
                assert plan["smem_bytes"] <= cc.CTX_SHARE_SMEM_BYTES, where
                assert plan["c_chunk"] <= ctx_dim, where
            if not ctx_dim:
                continue
            groups = cc.ctx_grad_groups(ps)
            assert [a for a, _ in groups] == list(range(0, ps, cc.CTX_GRAD_COLUMNS))
            assert sum(width for _, width in groups) == ps
            for _, width in groups:
                assert width % 4 == 0 and width <= cc.CTX_GRAD_COLUMNS
                for mode in (cc.PER_BATCH, cc.PER_ROW):
                    plan = cc.ctx_weight_grad_plan(rows, n, mode, ctx_dim, width)
                    where = (n_blocks, hidden, ctx_dim, mode, width, plan)
                    assert width // 4 <= cc.CTX_THREADS, where
                    if not plan["segments"]:
                        assert -(-plan["c_tile1"] // 4) * (width // 4) <= cc.CTX_THREADS, where
                    assert max(plan["smem_bytes1"], plan["smem_bytes2"]) <= cc.MAX_SMEM_BYTES
            plan = cc.ctx_input_grad_plan(rows, ctx_dim, ps)
            assert plan["grid"][0] * plan["tile_rows"] >= rows
            assert plan["grid"][1] * plan["tile_cols"] >= ctx_dim
            assert (plan["chunks"] - 1) * cc.CTX_IN_CHUNK < ps <= plan["chunks"] * cc.CTX_IN_CHUNK
