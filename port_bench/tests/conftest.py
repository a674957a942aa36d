"""The benchmark's CPU tests run several processes at once (``-n``): a few
threads each keep them from starving one another."""
import os

import torch

THREADS = 2
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
torch.set_num_threads(THREADS)
