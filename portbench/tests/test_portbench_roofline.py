"""The yardstick's work counts against values worked by hand."""
from __future__ import annotations

import pytest

from conftest import ROOT

from portbench import harness, roofline

DENSE = harness.load_module(ROOT / "portbench" / "roofline" / "dense.py")
MAMBA2 = harness.load_module(ROOT / "portbench" / "roofline" / "mamba2.py")


def test_flash_work_small():
    # B 1, S 4, H 2, Hkv 1, D 8: 4 * 5 / 2 = 10 visible pairs a head;
    # 2 products x 2 operations x D 8 = 32 a pair, x 2 heads x 10 = 640;
    # q and o 4 x 2 x 8, k and v 4 x 1 x 8 elements of 2 bytes = 384
    assert roofline.flash_work(1, 4, 2, 1, 8, esize=2) == (640, 384)
    # not causal: all 16 pairs
    assert roofline.flash_work(1, 4, 2, 1, 8, esize=2, causal=False)[0] \
        == 4 * 2 * 8 * 16


def test_flash_bound_at_phi3_4k():
    # [2, 4096], 32/32 heads of 96: 4096 * 4097 / 2 = 8,390,656 pairs a
    # head; 4 * 2 * 32 * 96 = 24,576 operations a pair-head-row
    flops = 24_576 * 8_390_656
    assert flops == 206_208_761_856
    t, by = roofline.flash_bound_s(2, 4096, 32, 32, 96)
    assert by == "operations"
    assert t == pytest.approx(206_208_761_856 / 989e12)
    # its bytes: 2 x 2 x 4096 x 64 x 96 x 2 = 201,326,592 at 3.35 TB/s
    assert roofline.flash_work(2, 4096, 32, 32, 96)[1] == 201_326_592


def test_ssd_work_small():
    # B 1, T 8, H 2, P 4, G 1, N 3, Q 4: 2 chunks, 10 causal pairs a chunk;
    # C B^T 1 x 10 x 3 = 30, weights x X 2 x 10 x 4 = 80, state in and
    # out 2 x 2 x 4 x 3 x 4 = 192 multiply-adds a chunk: 2 x 2 x 302
    assert roofline.ssd_work(1, 8, 2, 4, 1, 3, 4)[0] == 1208
    # x and y 8 x 2 x 4 each, B and C 8 x 3 each, dt 8 x 2, a 2: 194 floats
    assert roofline.ssd_work(1, 8, 2, 4, 1, 3, 4)[1] == 4 * 194


def test_ssd_bound_at_mamba2_is_bytes():
    # [4, 2048], 80 heads of 64, N 128, chunk 128: 16 chunks, 8256 pairs
    flops = 2 * 4 * 16 * (8256 * 128 + 80 * 8256 * 64
                          + 2 * 80 * 128 * 128 * 64)
    assert flops == 27_020_754_944
    nbytes = 4 * (2 * 4 * 2048 * 80 * 64 + 2 * 4 * 2048 * 128
                  + 4 * 2048 * 80 + 80)
    assert nbytes == 346_554_688
    t, by = roofline.ssd_bound_s(4, 2048, 80, 64, 1, 128, 128)
    assert by == "bytes" and t == pytest.approx(346_554_688 / 3.35e12)
    assert 27_020_754_944 / 495e12 < t


def test_model_flops_dense_small():
    m = dict(n_layers=1, d_model=4, head_dim=2, n_heads=2, n_kv_heads=1,
             d_ff=3, act="swiglu", vocab=5)
    # a token: q 2*4*4, k and v 2*4*2 each (64); o 2*4*4 (32); gate, up,
    # down 3 * 2*4*3 (72): 168, x 3 tokens = 504; attention 6 pairs a
    # head x 2 heads x 4 * 2 = 96; head at the last position 2*4*5 = 40
    w = DENSE.work(m, 1, 3)
    assert w["flops"] == 504 + 96 + 40
    assert w["flash"] == [(1, 3, 2, 1, 2)] and w["ssd"] == []
    m["act"] = "relu2"               # no up projection: 24 fewer a token
    assert DENSE.work(m, 1, 3)["flops"] == 504 - 3 * 24 + 96 + 40


def test_model_flops_ssm_small():
    m = dict(n_layers=1, d_model=4, expand=2, ssm_ngroups=1, d_state=2,
             ssm_headdim=4, d_conv=2, chunk=2, vocab=5)
    # d_inner 8, 2 heads, conv 12 channels; a token: in_proj 2*4*22,
    # out_proj 2*8*4, conv 2*2*12 = 288, x 4 tokens = 1152; the scan
    # (2 chunks of 3 pairs): 2 * 2 * (3*2 + 2*3*4 + 2*2*2*2*4) = 376;
    # head 40
    w = MAMBA2.work(m, 1, 4)
    assert w["flops"] == 1152 + 376 + 40
    assert w["ssd"] == [(1, 4, 2, 4, 1, 2, 2)] and w["flash"] == []


def test_model_flops_phi3_4k():
    per_token = (2 * 3072 * 96 * (32 + 64) + 2 * 32 * 96 * 3072
                 + 3 * 2 * 3072 * 8192)
    assert per_token == 226_492_416
    total = 32 * (8192 * per_token + 206_208_761_856) + 2 * 2 * 3072 * 32064
    cfg = harness.load_cell(ROOT, "phi3-mini-3.8b.conv-2k").model
    w = DENSE.work(cfg, 2, 4096)
    assert w["flops"] == total == 65_972_702_281_728
    assert w["flash"] == [(2, 4096, 32, 32, 96)] * 32
