"""The yardstick's operation and byte counts against hand counts at small
shapes."""

from __future__ import annotations

import pytest

from benchlib import counts


def test_k3_counts_by_hand():
    # B=1, N=2, 1 iteration: 4 pairs × ((1 + 2)·15 + 11 + 14) operations;
    # 4 bytes × (3·2 + 1·9·2 + 2·2 + 2·2) floats
    ops, nbytes = counts.k3_ops_bytes(1, 2, 1)
    assert ops == 4 * (3 * 15 + 11 + 14) == 280
    assert nbytes == 4 * (6 + 18 + 4 + 4) == 128
    ms, by = counts.bound_ms(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(128 / 3.35e12 * 1e3)
    ms, by = counts.bound_ms(0.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_chain_and_share_ops_by_hand():
    # hidden 1: per MLP 2 + 2 + 2 + 2 + 1 + 2 = 11; per block 4·11 + 8 = 52
    assert counts.chain_ops(1, 1, 1) == 52
    assert counts.chain_ops(10, 2, 1) == 10 * 2 * 52
    # per context row: 4 nets × H entries × (2C + 1)
    assert counts.share_ops(1, 1, 1, 1) == 12
    assert counts.share_ops(3, 2, 4, 8) == 3 * 4 * 2 * 8 * 9


def test_coupling_backward_is_three_forward_chains_and_the_context_folds():
    fwd, _ = counts.coupling_ops_bytes(100, 2, 4, 2, 8, 8, False)
    bwd, _ = counts.coupling_ops_bytes(100, 2, 4, 2, 8, 8, True)
    assert fwd == counts.chain_ops(100, 2, 8) + counts.share_ops(2, 2, 4, 8)
    assert bwd == 3 * counts.chain_ops(100, 2, 8) + 100 * 4 * 2 * 8 + counts.share_ops(2, 2, 4, 8)


def test_convolutions_by_hand():
    enc, dec = counts.conv_ops_per_frame(128)
    hand_enc = (2 * 3 * 16 * 16 * 64 * 64 + 2 * 16 * 32 * 16 * 32 * 32 + 2 * 32 * 64 * 16 * 16 * 16
                + 2 * 64 * 128 * 16 * 8 * 8 + 2 * 128 * 256 * 16 * 4 * 4)
    hand_dec = (2 * 256 * 128 * 16 * 4 * 4 + 2 * 128 * 64 * 16 * 8 * 8 + 2 * 64 * 32 * 16 * 16 * 16
                + 2 * 32 * 16 * 16 * 32 * 32 + 2 * 16 * 3 * 16 * 64 * 64)
    assert enc == hand_enc and dec == hand_dec
    assert counts.first_conv_ops(128) == 2 * 3 * 16 * 16 * 64 * 64


def test_step_ops_of_the_bootstrap_model_by_hand():
    from nfdpf_torch import DPFConfig

    cfg = DPFConfig(measurement="cos", hidden_size=32)
    b, n, t = 2, 16, 3
    enc, dec = counts.conv_ops_per_frame(128)
    dense = 2 * 4096 * 32 * 2
    frames = b * t * (3 * (enc + dec + dense) - counts.first_conv_ops(128))
    particles = t * 3 * b * n * 2 * (2 * 16 + 16 * 32 + 32 * 32)
    assert counts.step_model_ops(cfg, b, n, t) == frames + particles


def test_sinkhorn_ops_by_hand():
    # 2 firings, 10 iterations in all, B=1, N=2: 4 pairs × (15·(10 + 4) + 2·39)
    assert counts.sinkhorn_ops(1, 2, 2, 10) == 4 * (15 * 14 + 2 * 39)
