"""The yardstick's arithmetic: the chip's peaks, the operations of the
NeRF MLP's functions and the bytes each kernel launch must move.

The operation counts are a frozen copy of
``nerf_pytorch_paeng_tpu_torch/kernels/fused_mlp.py``'s
``sigma_flop_per_sample``, ``eval_flop_per_sample``,
``eval_flop_per_ray`` and ``bwd_flop_per_sample`` (multiply-add = 2; the
kernels' zero padding and the backward's recompute of the forward are not
counted), and the packed weight sizes a copy of its ``_W_LAYOUT`` and
``_B_LAYOUT`` (each entry padded to 8 elements).  A later change to the
program does not move these numbers.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

WIDTH = 256
EMBX_ROWS, EMBD_ROWS = 64, 32


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


# the packed layout's entries: (rows, cols) of each weight, length of each bias
_W_SHAPES = ((EMBX_ROWS, WIDTH), (WIDTH, WIDTH), (WIDTH, WIDTH),
             (WIDTH, WIDTH), (WIDTH, WIDTH), (EMBX_ROWS, WIDTH),
             (WIDTH, WIDTH), (WIDTH, WIDTH), (WIDTH, WIDTH), (WIDTH, WIDTH),
             (WIDTH, WIDTH // 2), (EMBD_ROWS, WIDTH // 2), (WIDTH, 1),
             (WIDTH // 2, 3))
_B_SIZES = (WIDTH,) * 9 + (WIDTH // 2, 1, 3)
W_TOTAL = sum(_pad8(r * c) for r, c in _W_SHAPES)       # bf16 on the card
B_TOTAL = sum(_pad8(n) for n in _B_SIZES)               # float32


def sigma_flop_per_sample(L_x: int = 10) -> int:
    """Trunk and the 1-wide density head."""
    in_x = 3 + 6 * L_x
    return 2 * (in_x * WIDTH + 6 * WIDTH * WIDTH + (in_x + WIDTH) * WIDTH
                + WIDTH)


def eval_flop_per_sample(L_x: int = 10) -> int:
    """The trunk's work plus the feature, view and colour products."""
    return sigma_flop_per_sample(L_x) + 2 * (
        WIDTH * WIDTH + WIDTH * (WIDTH // 2) + (WIDTH // 2) * 3)


def eval_flop_per_ray(L_d: int = 4) -> int:
    """The direction term of the view layer, once per ray."""
    return 2 * (3 + 6 * L_d) * (WIDTH // 2)


def bwd_flop_per_sample(L_x: int = 10, L_d: int = 4) -> int:
    """Every weight's gradient and every layer's input gradient but the
    first's, the skip's embedding rows and the direction rows."""
    in_x, in_d = 3 + 6 * L_x, 3 + 6 * L_d
    chain = (7 * WIDTH * WIDTH + WIDTH * WIDTH + WIDTH * (WIDTH // 2)
             + WIDTH + (WIDTH // 2) * 3)
    weights = chain + 2 * in_x * WIDTH + in_d * (WIDTH // 2)
    return 2 * (chain + weights)


def roofline_s(flop: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the bf16 peak or
    bytes at the memory peak, whichever is longer."""
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def _weight_bytes() -> int:
    return 2 * W_TOTAL + 4 * B_TOTAL


def k1_train_launch(n: int, s: int, L_x: int = 10, L_d: int = 4):
    """(operations, bytes) of one training forward launch (K1) over n rays
    of s samples: reads the rays [8, n] and depths [s, n] (float32) and
    the packed weights once, writes four [s, n] float32 logits."""
    flop = n * s * eval_flop_per_sample(L_x) + n * eval_flop_per_ray(L_d)
    nbytes = 4 * 8 * n + 4 * s * n + _weight_bytes() + 4 * 4 * s * n
    return flop, nbytes


def k2_train_launch(n: int, s: int, L_x: int = 10, L_d: int = 4):
    """(operations, bytes) of one training backward (K2: its chain,
    weight-gradient and reduction launches together) over n rays of s
    samples: reads the rays, depths, four float32 cotangents and the
    weights once, writes the float32 gradients of the packed weights."""
    flop = n * s * bwd_flop_per_sample(L_x, L_d)
    nbytes = (4 * 8 * n + 4 * s * n + 4 * 4 * s * n + _weight_bytes()
              + 4 * (W_TOTAL + B_TOTAL))
    return flop, nbytes


def train_step_flop(n: int, s_c: int, s_f: int, L_x: int = 10,
                    L_d: int = 4) -> int:
    """Model operations of one training step: n rays, the coarse pass at
    s_c samples and the fine pass at s_c + s_f, forward and backward at
    every sample, the direction term once a ray and pass."""
    per_sample = eval_flop_per_sample(L_x) + bwd_flop_per_sample(L_x, L_d)
    return n * ((2 * s_c + s_f) * per_sample + 2 * eval_flop_per_ray(L_d))
