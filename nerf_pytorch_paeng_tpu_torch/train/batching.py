"""Global ray-batch pool: every train pixel's (ray_o, ray_d, rgb) triple
on the device, reshuffled each epoch.

Counterpart of the JAX package's ``train/batching.py`` (reference
main.py:93-106 and utils.py:41-58): the pool is one [M, 3, 3] tensor,
batches are slices of it, and only the integer cursor lives on the host.

Under a process group every rank holds the whole pool in the same order
and takes the same global batch (the train step keeps its slice): each
shuffle's permutation is rank 0's, broadcast (``_permutation``), so that
no rank trains on other rays than the others think it does.  Without a
group, or at world size 1, the permutation is the generator's own.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import parallel
from ..ops.rays import get_rays_batched
from ..utils.spans import setup_span, span


def _permutation(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """``randperm(n)`` from ``generator``, rank 0's on every rank."""
    perm = torch.randperm(n, generator=generator, device=device)
    if parallel.world_size() > 1:
        parallel.broadcast0(perm)
    return perm


def build_ray_pool(images: np.ndarray, K, poses: np.ndarray,
                   i_train: np.ndarray, generator: torch.Generator,
                   device) -> torch.Tensor:
    """[M, 3, 3] pool of (ray_o, ray_d, rgb) for all train pixels, shuffled
    by ``generator`` (on ``device``).  images [N, H, W, 3]; poses
    [N, 3or4, 4].  Set-up span ``setup.pool``."""
    H, W = images.shape[1:3]
    idx = np.asarray(i_train)
    with setup_span("setup.pool"):
        poses_train = torch.as_tensor(np.asarray(poses)[idx, :3, :4],
                                      dtype=torch.float32, device=device)
        rays_o, rays_d = get_rays_batched(H, W, K, poses_train)  # [T,H,W,3]
        rgb = torch.as_tensor(np.asarray(images, np.float32)[idx],
                              device=device)
        pool = torch.stack([rays_o, rays_d, rgb], 3).reshape(-1, 3, 3)
        return pool[_permutation(len(pool), generator, device)]


class RayPool:
    """Cursor over the shuffled pool; reshuffles (with its own generator)
    when a batch would run past the end."""

    def __init__(self, pool: torch.Tensor, generator: torch.Generator):
        self.pool = pool
        self.generator = generator
        self.i_batch = 0
        self.epoch = 0

    def _reshuffle(self) -> None:
        with span("pool.reshuffle"):
            self.pool = self.pool[_permutation(len(self.pool),
                                               self.generator,
                                               self.pool.device)]
        self.epoch += 1

    def next_start(self, n: int) -> int:
        """Advance the cursor and return the batch's start offset."""
        if self.i_batch + n > len(self.pool):
            self._reshuffle()
            self.i_batch = 0
        start = self.i_batch
        self.i_batch += n
        return start

    def next_batch(self, n: int):
        """The next ``n`` rays: (rays_o, rays_d, rgb), each [n, 3]."""
        start = self.next_start(n)
        batch = self.pool[start:start + n]
        return tuple(batch[:, k].contiguous() for k in range(3))

    def fast_forward(self, steps: int, n: int) -> None:
        """Replay ``steps`` completed ``next_start(n)`` calls: the pool's
        trajectory is fixed by (initial pool, generator, step count), so a
        resumed run rebuilds the pool and serves the same batches as the
        uninterrupted one.  Reshuffles fire at the start of calls
        per_epoch + 1, 2 per_epoch + 1, ... (per_epoch = M // n)."""
        if steps <= 0:
            return
        per_epoch = len(self.pool) // n
        if per_epoch <= 0:
            raise ValueError(f"pool of {len(self.pool)} rays < batch {n}")
        reshuffles = (steps - 1) // per_epoch
        for _ in range(reshuffles):
            self._reshuffle()
        self.i_batch = (steps - reshuffles * per_epoch) * n
