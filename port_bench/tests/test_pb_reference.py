"""The plain reference on tiny cases worked out by hand, and against the
program at float32 on the CPU (where the program's plain versions run
float32 end to end)."""
import math

import pytest
import torch

from port_bench.harness import fields
from port_bench.reference import nerf as ref


def test_posenc_layout():
    x = torch.tensor([[0.5, -1.0, 2.0]])
    e = ref.posenc(x, 2)
    want = torch.cat([x, torch.sin(x), torch.cos(x), torch.sin(2 * x),
                      torch.cos(2 * x)], -1)
    assert e.shape == (1, 15) and torch.equal(e, want)


def test_composite_two_samples():
    # sigma 1 over a gap of 0.5 on a unit ray, then the capped last bin
    raw = torch.tensor([[[0.0, 0.0, 0.0, 1.0], [10.0, 10.0, 10.0, 2.0]]])
    z = torch.tensor([[1.0, 1.5]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    rgb, disp, w = ref.composite(raw, z, d)
    a0 = 1 - math.exp(-0.5)
    w1 = 1.0 * (1 - a0 + 1e-10)          # the last bin is opaque
    assert w[0, 0].item() == pytest.approx(a0, rel=1e-6)
    assert w[0, 1].item() == pytest.approx(w1, rel=1e-6)
    c1 = 1 / (1 + math.exp(-10))
    assert rgb[0, 0].item() == pytest.approx(a0 * 0.5 + w1 * c1
                                             + 1 - (a0 + w1), abs=1e-6)
    depth = a0 * 1.0 + w1 * 1.5
    assert disp[0].item() == pytest.approx((a0 + w1) / depth, rel=1e-6)


def test_composite_empty_ray_is_white_with_zero_disparity():
    raw = torch.zeros(1, 4, 4)
    raw[..., 3] = -3.0
    rgb, disp, _ = ref.composite(raw, torch.linspace(2, 6, 4)[None],
                                 torch.tensor([[0.0, 0.0, -1.0]]))
    assert torch.equal(rgb, torch.ones(1, 3)) and disp.item() == 0.0


def test_stratified_bins():
    z = ref.stratified(torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]),
                       2.0, 6.0)
    assert torch.allclose(z, torch.tensor([[2.0, 3.0, 5.0],
                                           [3.0, 5.0, 6.0]]))


def test_sample_pdf_uniform_masses_is_linear():
    bins = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    u = torch.tensor([[0.0, 0.5, 0.9]])
    z = ref.sample_pdf(bins, torch.ones(1, 3), u)
    assert torch.allclose(z, 3.0 * u, atol=1e-6)


FIELD = {"r": 1.5, "k": 20.0, "mix": 12.0, "gain": 1.5, "octave": 0.5,
         "geometry_seed": 3}


def test_ball_field_by_hand():
    """The ball field: units 0-5 carry x's halves through the trunk, so
    the density is k (r - |x|_1) plus the seeded units' readout; both modules share the trunk and density,
    and each has its own colour branch."""
    g = torch.Generator().manual_seed(0)
    sd = fields.ball_state_dict(FIELD, g, "cpu")
    p = ref.module(sd, "model_coarse")
    x = torch.tensor([[0.3, -0.2, 0.4], [1.0, 1.0, 0.0]])
    emb = ref.posenc(x, 10)
    h = emb
    for i in range(8):
        h = torch.relu(ref._dense(h, p, f"linear_x.{i}", ref.identity))
        halves = torch.stack([x.clamp(min=0), (-x).clamp(min=0)],
                             -1).reshape(2, 6)
        assert torch.allclose(h[:, :6], halves, atol=1e-6)
        if i == 4:
            h = torch.cat([emb, h], -1)
    raw = ref.mlp(p, emb, ref.posenc(x, 4))
    seeded = h[:, 6:] @ p["linear_density.weight"][0, 6:]
    assert seeded.abs().max() > 0.1
    assert torch.allclose(raw[:, 3], 20.0 * (1.5 - x.abs().sum(-1)) + seeded,
                          atol=1e-4)
    for name in ("linear_x.3", "linear_density"):
        assert torch.equal(sd[f"model_coarse.{name}.weight"],
                           sd[f"model_fine.{name}.weight"])
    assert not torch.equal(sd["model_coarse.linear_color.weight"],
                           sd["model_fine.linear_color.weight"])
    # the geometry is the same for every run's seed, the colours are not
    other = fields.ball_state_dict(FIELD, torch.Generator().manual_seed(1),
                                   "cpu")
    assert torch.equal(other["model_fine.linear_x.3.weight"],
                       sd["model_fine.linear_x.3.weight"])
    assert not torch.equal(other["model_fine.linear_d.weight"],
                           sd["model_fine.linear_d.weight"])


def test_ball_field_reads_every_column():
    """Every encoding column, every unit and every direction column has
    weights: no tile of a product is zero."""
    sd = fields.ball_state_dict(FIELD, torch.Generator().manual_seed(1),
                                "cpu")
    for key, w in sd.items():
        if key.endswith(".weight") and "density" not in key:
            assert (w.abs().sum(0) > 0).all(), key
            assert (w.abs().sum(1) > 0).all(), key


def test_adam_first_step_moves_by_lr():
    p = {"w": torch.tensor([1.0, 2.0, 3.0])}
    g = {"w": torch.tensor([0.5, -2.0, 0.0])}
    ref.Adam(p).step(p, g, 0.1)
    assert torch.allclose(p["w"], torch.tensor([0.9, 2.1, 3.0]), atol=1e-6)


def test_lr_schedule():
    assert ref.lr_at(0, 200001, 10000, 5e-4, 5e-5) == 5e-5
    assert ref.lr_at(10000, 200001, 10000, 5e-4, 5e-5) == pytest.approx(5e-4)
    assert ref.lr_at(200001, 200001, 10000, 5e-4, 5e-5) == pytest.approx(5e-5)


def test_ndc_of_the_optical_axis():
    o, d = ref.ndc(4, 4, 2.0, torch.zeros(1, 3),
                   torch.tensor([[0.0, 0.0, -1.0]]))
    assert torch.allclose(o, torch.tensor([[0.0, 0.0, -1.0]]))
    assert torch.allclose(d, torch.tensor([[0.0, 0.0, 2.0]]))


def test_round_fp8():
    x = torch.tensor([448.0, -224.0, 1.75, 0.0])
    assert torch.equal(ref.round_fp8(x), x)          # representable
    y = torch.linspace(-1, 1, 1001)
    err = (ref.round_fp8(y) - y).abs() / y.abs().clamp(min=1 / 64)
    assert err.max() <= 2 ** -4 and err.max() > 2 ** -8


def test_step_generator_matches_the_program():
    from nerf_pytorch_paeng_tpu_torch.train.step import step_generator
    for seed, step in ((3, 0), (2 ** 31 + 5, 7)):
        a = torch.rand(5, generator=ref.step_generator(seed, step, "cpu"))
        b = torch.rand(5, generator=step_generator(seed, step, "cpu"))
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell,scene", [
    ("lego.train", dict(H=32, W=32, n_train=3)),
    ("fern.train", dict(H=48, W=64, n_views=6, testskip=3, n_samples=32))])
def test_reference_follows_the_program_at_float32(cell, scene):
    """The program's first three updates on its plain route at
    compute_dtype float32 on the CPU (float32 throughout, the reference
    positional encoding) against the reference: only the sums' order
    differs, which the encoding's top band (2^9 x) amplifies.  (The
    kernels' plain versions differ by more at float32: their embedding
    takes the double-angle recurrence, as the kernels do.)"""
    from port_bench.run import make_ctx, run_cell
    ctx = make_ctx(cell, 2 ** 31 + 77, 0.0, False, torch.device("cpu"),
                   0.0, nerf_overrides=dict(N_rays=256, N_samples_c=8,
                                            N_samples_f=8,
                                            compute_dtype="float32",
                                            use_pallas=False),
                   scene_overrides=scene)
    out = run_cell(ctx)
    got = out["readings"]
    assert got["loss_gap"] < 5e-5, got
    assert got["grad_gap"] < 5e-4, got
    assert got["grad_noise_ratio"] < 1e-2, got
    assert got["change_gap"] < 5e-3, got
