"""A run with the timed path broken underneath comes out not correct.

Each fault a cell can have is planted in the program (``monkeypatch``)
and the rest of a run is driven without the look for a card
(``run.run_cell``):

- training: a step that leaves the state unchanged (Adam's step does
  nothing); half of the batch left out, the loss the mean over the rest;
- rendering: a frame's colours altered where the fine pass produces them
  (+0.02); the fine pass of half of a frame's cover blocks left out; one
  column tile (output units 64-127) of trunk layer 3 left out, in the
  fine module or in the coarse one.

The cells run on one card, so no exchange between chips exists to leave
out.  On the card (``-m cuda``) every cell runs at its own size, and the
same run unbroken is correct.  On the CPU, at a small size, each fault
must read above its number's limit and three times the unbroken run's
reading.

    python -m pytest port_bench/tests/test_pb_faults.py       # CPU
    python -m pytest -m cuda port_bench/tests/test_pb_faults.py   # card
"""
import copy

import pytest
import torch

from port_bench.run import make_ctx, run_cell

SMALL = {
    "lego.train": (dict(N_rays=256, N_samples_c=8, N_samples_f=8),
                   dict(H=32, W=32, n_train=3)),
    "fern.train": (dict(N_rays=256, N_samples_c=8, N_samples_f=8),
                   dict(H=48, W=64, n_views=6, testskip=3, n_samples=32)),
    "fern.render": (dict(N_samples_c=16, N_samples_f=32),
                    dict(H=24, W=32, n_views=6, testskip=3)),
}


def _state_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(mp):
    from nerf_pytorch_paeng_tpu_torch.train import step
    whole = step._loss_and_metrics

    def half(model, rays_o, rays_d, target, cfg, generator=None, u_c=None,
             u_f=None, support=None):
        h = rays_o.shape[0] // 2
        return whole(model, rays_o[:h], rays_d[:h], target[:h], cfg,
                     generator, None if u_c is None else u_c[:h],
                     None if u_f is None else u_f[:h], support)
    mp.setattr(step, "_loss_and_metrics", half)


def _colour_altered(mp):
    from nerf_pytorch_paeng_tpu_torch.eval import frame
    whole = frame.volume_render_rays_t

    def altered(*args):
        out = whole(*args)
        return out._replace(rgb=out.rgb + 0.02)
    mp.setattr(frame, "volume_render_rays_t", altered)


def _half_the_fine_blocks(mp):
    from nerf_pytorch_paeng_tpu_torch.eval import frame
    whole = frame._cover

    def half(*args):
        blocks = whole(*args)
        return blocks[:len(blocks) // 2]
    mp.setattr(frame, "_cover", half)


def _tile_zeroed(module):
    """Output units 64-127 of ``module``'s trunk layer 3 left out: one
    column tile of that product, where a kernel computes it."""
    def plant(mp):
        from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp
        whole = fused_mlp.pack_nerf

        def zeroed(model, cfg, device=None):
            model = copy.deepcopy(model)
            with torch.no_grad():
                getattr(model, module).linear_x[3].weight[64:128] = 0.0
            return whole(model, cfg, device)
        mp.setattr(fused_mlp, "pack_nerf", zeroed)
    return plant


FAULTS = {
    "train": {"state_unchanged": (_state_unchanged, "change_gap_median"),
              "half_batch": (_half_batch, "grad_noise_ratio")},
    "render": {"colour_altered": (_colour_altered, "rgb_rmse"),
               "half_fine_blocks": (_half_the_fine_blocks, "rgb_rmse"),
               "fine_tile_zeroed": (_tile_zeroed("model_fine"), "rgb_rmse"),
               "coarse_tile_zeroed": (_tile_zeroed("model_coarse"),
                                      "active_gap")},
}
# fern's rays meet the ball's opaque inside from the near plane on, so its
# coarse pass only places samples there: a coarse fault is lego.render's
# to catch (its active_gap), on the same sigma kernel (K4, gated K3)
NOT_SEEN = {"fern.render": ("coarse_tile_zeroed",)}
CASES = [(cell, kind, fault) for cell, kind in (
    ("lego.train", "train"), ("fern.train", "train"),
    ("lego.render", "render"), ("fern.render", "render"))
    for fault in FAULTS[kind] if fault not in NOT_SEEN.get(cell, ())]


def _numbers(cell, device, seed, small=True, seconds=1.5):
    nerf, scene = SMALL[cell] if small else (None, None)
    out = run_cell(make_ctx(cell, seed, seconds, False, device, 0.0,
                            nerf_overrides=nerf, scene_overrides=scene))
    return out["checks"]


@pytest.mark.parametrize("cell,kind,fault",
                         [c for c in CASES if c[0] in SMALL])
def test_fault_fails_the_check_on_the_cpu(cell, kind, fault, monkeypatch):
    # a render window long enough for a frame to arrive on a loaded host
    seconds = 4.0 if kind == "render" else 1.5
    sound = _numbers(cell, torch.device("cpu"), 2 ** 31 + 91, seconds=seconds)
    plant, number = FAULTS[kind][fault]
    plant(monkeypatch)
    broken = _numbers(cell, torch.device("cpu"), 2 ** 31 + 91,
                      seconds=seconds)
    got = broken.items[number]
    assert not broken.ok
    assert got["value"] > got["limit"]
    assert got["value"] > 3 * sound.items[number]["value"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode at the cells' sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kind,fault", CASES)
def test_fault_fails_the_check_on_the_card(cell, kind, fault, card,
                                           monkeypatch):
    if cell not in _SOUND:
        _SOUND[cell] = _numbers(cell, card, 2 ** 31 + 93, small=False)
    plant, number = FAULTS[kind][fault]
    plant(monkeypatch)
    broken = _numbers(cell, card, 2 ** 31 + 93, small=False)
    print(cell, fault, "sound", _SOUND[cell].items, "broken", broken.items)
    assert _SOUND[cell].ok
    assert not broken.ok, broken.items


_SOUND = {}     # each cell's unbroken run, once
