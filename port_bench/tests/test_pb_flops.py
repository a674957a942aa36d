"""The yardstick's arithmetic against a count by hand at 8x256, L_x 10,
L_d 4, and the kernels' bounds that PERF.md quotes."""
import pytest

from port_bench.harness import flops


def test_forward_counts_by_hand():
    # trunk: 63x256, six 256x256, the skip's 319x256, the density head 256
    trunk = 63 * 256 + 6 * 256 * 256 + (63 + 256) * 256 + 256
    assert flops.sigma_flop_per_sample(10) == 2 * trunk == 982_528
    # + feature 256x256, view 256x128, colour 128x3
    head = 256 * 256 + 256 * 128 + 128 * 3
    assert flops.eval_flop_per_sample(10) == 2 * (trunk + head) == 1_179_904
    assert flops.eval_flop_per_ray(4) == 2 * 27 * 128 == 6_912


def test_backward_count_by_hand():
    # input gradients: w1-w4, w5's hidden rows, w6, w7, feature, the
    # view layer's feature rows, both heads
    chain = 7 * 65536 + 65536 + 256 * 128 + 256 + 128 * 3
    # weight gradients: the same products plus w0, w5's embedding rows and
    # the view layer's direction rows
    weights = chain + 2 * 63 * 256 + 27 * 128
    assert flops.bwd_flop_per_sample(10, 4) == 2 * (chain + weights) \
        == 2_302_208


def test_packed_sizes():
    assert flops.W_TOTAL == 594_560       # 1.19 MB of bf16
    assert flops.B_TOTAL == 2_448


def test_bounds_quoted_in_perf():
    # the MLP bound of a 4096-ray, 64+128 training step: 3.692 ms
    step = flops.train_step_flop(4096, 64, 128)
    assert step == 4096 * (256 * (1_179_904 + 2_302_208) + 2 * 6_912)
    assert step / flops.PEAK_BF16_FLOPS * 1e3 == pytest.approx(3.692,
                                                              abs=5e-4)
    # K1 at 4096 x 192: 0.938 ms; K2 at 4096 x 192: 1.831 ms (both bound
    # by operations)
    f, b = flops.k1_train_launch(4096, 192)
    assert flops.roofline_s(f, b) == f / flops.PEAK_BF16_FLOPS
    assert flops.roofline_s(f, b) * 1e3 == pytest.approx(0.938, abs=5e-4)
    f, b = flops.k2_train_launch(4096, 192)
    assert flops.roofline_s(f, b) * 1e3 == pytest.approx(1.831, abs=5e-4)


def test_k2_bytes_by_hand():
    n, s = 4096, 64
    _, b = flops.k2_train_launch(n, s)
    reads = 4 * 8 * n + 4 * s * n + 4 * 4 * s * n + 2 * 594_560 + 4 * 2_448
    writes = 4 * (594_560 + 2_448)
    assert b == reads + writes


def test_memory_bound_when_few_operations():
    assert flops.roofline_s(1.0, 3.35e12) == pytest.approx(1.0)
