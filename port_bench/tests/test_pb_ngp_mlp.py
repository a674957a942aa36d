"""``ngp_mlp_ms.train`` on a stub trace: the NGP field's three fused MLP
kernels' traced ms a step, read only where their launch counters
(positions 16-18 of ``kernels.LAUNCH_COUNTERS``) equal the traced steps
and the trace holds one of each a step.

    python -m pytest port_bench/tests -q
"""
import pytest

from port_bench.harness.common import load_reader

MLP_KERNELS = ("ngp_mlp_fwd_kernel", "ngp_mlp_bwd_kernel",
               "ngp_mlp_reduce_kernel")


class _StubTrace:
    """The kernels a profiled window saw: (name, start, seconds)."""

    def __init__(self, ops):
        self.ops = ops

    def time_of(self, names):
        hits = [d for n, _, d in self.ops if n in names]
        return sum(hits), len(hits)


@pytest.mark.parametrize("case", ["engaged", "parent", "short_count",
                                  "missing_launch", "no_trace", "nerf"])
def test_the_mlp_reader_reads_only_where_its_counters_match(case):
    """A value where the counters and the trace agree; nothing on a program
    without the counters (the parent's 16), where they disagree, without a
    trace, or in a NeRF cell."""
    steps = 4
    counts = [steps] * 19
    ops = [(k, 0.0, 1e-5) for _ in range(steps) for k in MLP_KERNELS]
    if case == "parent":
        counts = counts[:16]
    elif case == "short_count":
        counts[17] = steps - 1
    elif case == "missing_launch":
        ops = ops[1:]
    rec = dict(kind="train", arch="nerf" if case == "nerf" else "ngp",
               trace=None if case == "no_trace" else _StubTrace(ops),
               trace_steps=steps, trace_launches=counts)
    value = load_reader("ngp_mlp_ms.train")(rec)
    if case == "engaged":
        assert value == pytest.approx(3 * 1e-2)
    else:
        assert value is None
