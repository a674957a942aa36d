"""The control comes out not correct, on the card at the cells' sizes.

The control is the cell's architecture's reference (``arch/<name>.py``)
put in the program's place at the operand precision below the
configuration's (``ROUND_CONTROL``; for the bfloat16 cells here scaled
float8 e4m3, float32 sums); a render cell's control draws its own fine
uniforms, as the program's are its own.  On three
seeds of each cell at least one of the cell's numbers reads above its
limit.  ``port_bench/readings.py`` prints the same readings.

    python -m pytest -m cuda port_bench/tests/test_pb_control.py -s
"""
import pytest
import torch

from port_bench import arch, readings
from port_bench.run import make_ctx

SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cells' "
                    "sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lego.train", "fern.train",
                                  "lego.render", "fern.render"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cell, seed, card):
    ctx = make_ctx(cell, seed, 0.0, False, card, 0.0)
    rnd = arch.of(ctx.config).ROUND_CONTROL
    numbers = (readings.train_control(ctx, rnd=rnd)
               if ctx.workload["kind"] == "train"
               else readings.render_control(ctx))
    limits = ctx.workload["check"]["limits"]
    print(cell, seed, numbers)
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)
