"""The port's multi-rank dry run (``python -m
nerf_pytorch_paeng_tpu_torch.dryrun N --device cpu``), the analog of the
JAX package's ``__graft_entry__.dryrun_multichip``: at 2 and 4 gloo ranks
on the CPU, every rank runs the six phases and checks its replicated
results against rank 0's (a rank that differs fails the run), rank 0
prints six ``OK`` lines and the JSON report, and no kernel launches on
the CPU.  Each rank has 120 s (``--timeout``)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from nerf_pytorch_paeng_tpu_torch import dryrun

from torch_port_util import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, threads: int = 1):
    env = {**subprocess_env(), "OMP_NUM_THREADS": str(threads)}
    return subprocess.run(
        [sys.executable, "-m", "nerf_pytorch_paeng_tpu_torch.dryrun", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_runs_every_phase(n):
    proc = _run(str(n), "--device", "cpu", "--timeout", "120",
                threads=max(1, torch.get_num_threads() // n))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ok = [line for line in proc.stdout.splitlines()
          if line.startswith("dryrun OK (")]
    assert [line.split(":")[0] for line in ok] == [
        f"dryrun OK ({i}" for i in range(1, 7)]
    layout = f"{n // 2} x 2"
    assert f"layout {layout}" in ok[0] and f"sp={n}" in ok[4]
    report = json.loads(proc.stdout.strip().splitlines()[-1])["dryrun"]
    assert [p["phase"] for p in report] == list(dryrun.PHASES)
    assert all(p["launches"] == {} for p in report)     # plain on the CPU
    assert "gate_frac=0.500" in ok[5]    # the tangent half, gated whole


def test_dryrun_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: --device cuda would run")
    proc = _run("2", "--device", "cuda")
    assert proc.returncode != 0
    assert "torch sees no CUDA device" in proc.stderr
