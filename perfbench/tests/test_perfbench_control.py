"""The cell's control, the plain reference one precision below the
configuration's, comes out not correct against the cell's limits: at a
size a test can hold (on the card it ran at the cell's own size, PERF.md
section 2)."""

import torch

from perfbench import control, run as bench_run
from perfbench.harness import checks
from perfbench.tests import cases


def test_control_fails_a_limit():
    readings = control.serve_control(cases.config(), cases.mix(),
                                     cases.SEED, torch.device("cpu"))
    ok, _ = checks.judge(readings, checks.load_limits(bench_run.ROOT,
                                                      cases.PREFILL))
    assert not ok, readings


def test_float8_keeps_three_bits_and_the_scale():
    x = torch.tensor([448.0, -3.0, 1.0 + 2 ** -4, 0.0, 1e-9])
    got = control.round_e4m3(x)
    assert got[0] == 448.0 and got[1] == -3.0 and got[3] == 0.0
    assert got[2] == 1.0 + 2 ** -3 or got[2] == 1.0     # 3 mantissa bits
    assert control.round_e4m3(x * 1e-6)[0] == torch.tensor(448e-6)


def test_the_control_reads_the_longest_prompt_of_a_cycle():
    from perfbench.harness import traffic
    mix = cases.mix()
    picks = control.check_indices(mix, cases.SEED)
    lengths = [traffic.prompt_length(mix, cases.SEED, i) for i in picks]
    assert max(lengths) == max(traffic.length_strata(mix))
    assert len(picks) >= mix["check_batches"] - 1
