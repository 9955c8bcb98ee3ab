"""The benchmark's fixed arithmetic against counts made by hand."""

import pytest

import yardstick


def test_attention_bound_at_a_small_shape():
    # B=1, L=4, H=1, D=8, bf16, causal: 10 pairs; q, k, v, o of 4*8*2 bytes,
    # the lse of 4*4 bytes.
    ms, by = yardstick.attention_bound_ms(1, 4, 1, 8, "bfloat16", True, "fwd")
    assert by == "bytes" and ms == pytest.approx((4 * 64 + 16) / 3.35e12 * 1e3)
    ms, by = yardstick.attention_bound_ms(1, 4, 1, 8, "bfloat16", True, "dkv")
    assert ms == pytest.approx((6 * 64 + 2 * 16) / 3.35e12 * 1e3)
    # B=2, L=1024: 2 * 1024 * 1025 / 2 pairs at 8 D FLOPs each (dkv)
    # outweigh 6 tensors of 2*1024*8*2 bytes and 2 vectors of 2*1024*4.
    flops = 8 * 8 * (2 * 1024 * 1025 // 2)
    ms, by = yardstick.attention_bound_ms(2, 1024, 1, 8, "bfloat16", True, "dkv")
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)


def test_bound_picks_the_larger_of_bytes_and_operations():
    assert yardstick.bound_ms(3.35e12, 0, "bfloat16") == (pytest.approx(1e3), "bytes")
    assert yardstick.bound_ms(0, 989e12, "bfloat16") == (pytest.approx(1e3), "operations")


def test_lm_step_flops_by_hand():
    # B=1, L=2, dim=4, 1 layer, vocab 10: matmuls 2*2*(12*16 + 40) = 928;
    # attention 4*4*3 pairs = 48; three times the forward.
    assert yardstick.lm_step_flops(1, 2, 4, 1, 10, 2) == 3 * (928 + 48)


def test_lm_step_flops_of_gpt2_small_at_the_cell():
    assert yardstick.lm_step_flops(16, 1024, 768, 12, 50257, 12) == pytest.approx(13.07e12, rel=1e-3)


def test_deepfm_step_flops_by_hand():
    # 1 row, 2 integers, 3 fields of dim 2, one hidden layer of 4: widths
    # 8 -> 4 -> 1: 2*8*4+4 + 2*4*1+1 = 77; FM 4*3*2 = 24; first order 3+4.
    assert yardstick.deepfm_step_flops(1, 2, 3, 2, (4,)) == 3 * (77 + 24 + 7)


def test_kernel_groups():
    assert yardstick.kernel_group("void fwd_wgmma_kernel<64>(...)") == "flash_fwd"
    assert yardstick.kernel_group("dkv_wgmma_kernel") == "flash_dkv"
    assert yardstick.kernel_group("nvjet_tst_192x192") == "matmul"
    assert yardstick.kernel_group("elementwise_kernel") == "other"


def test_the_rate_counts_the_part_of_a_straddling_task_inside_the_window():
    import harness
    import readers

    # Tasks of 10 records reported at 1, 2, 3 and 4 s; a window from 1.5 s
    # to 3.5 s holds two tasks' worth of work.
    reports = [(t, i, "training", True, 10, 0.0) for i, t in enumerate((1.0, 2.0, 3.0, 4.0))]
    w = harness.Window(t0=1.5, t1=3.5, seconds=2.0, reports=reports, units_per_record=3,
                       minibatch=5, step_flops=989e12)
    assert readers.records_per_s(w) == pytest.approx(10.0)
    assert readers.rate(w) == pytest.approx(30.0)
    assert readers.mfu(w) == pytest.approx(100.0 * 10.0 / 5)
