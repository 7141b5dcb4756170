"""The metric readers' arithmetic over whole windows, the traffic's
determinism by seed, and the check's numbers."""

import math

import numpy as np
import pytest

from perfbench.harness import checks, readers, traffic
from perfbench.run import load_reader
from perfbench.tests import cases


def _serve_run(latencies, lengths, seconds, ok=None):
    batches = []
    for i, (lat, n) in enumerate(zip(latencies, lengths)):
        good = ok is None or ok[i]
        batches.append({"due": 10.0 * i, "done": 10.0 * i + lat, "rows": 4,
                        "length": n, "ok": good, "prefill_s": lat / 2})
    return {"kind": "serve", "mix": {"max_new_tokens": 1},
            "window": {"seconds": seconds, "batches": batches,
                       "tokens": sum(4 * (n + 1) for n in lengths),
                       "units": len(batches)}}


def test_p95_is_over_every_request():
    lat = [0.1 * (i + 1) for i in range(20)]
    run = _serve_run(lat, [256] * 20, 100.0)
    per_request = sorted(x for x in lat for _ in range(4))
    assert load_reader("ttft_p95_s")(run) == pytest.approx(
        np.percentile(per_request, 95))


def test_a_failed_request_counts_as_never_answered():
    run = _serve_run([0.1] * 19 + [0.2], [256] * 20, 100.0,
                     ok=[True] * 19 + [False])
    assert math.isinf(load_reader("ttft_p95_s")(run))


def test_rates_are_the_window_work_over_the_window_time():
    run = _serve_run([0.5, 0.7], [256, 1024], 3.0)
    assert load_reader("serve_tokens_per_s")(run) == pytest.approx(
        4 * (257 + 1025) / 3.0)


def test_entk_overhead_and_session_rate():
    run = _serve_run([0.4, 0.6], [256, 512], 2.0)
    assert load_reader("entk_overhead_ms.serve")(run) == pytest.approx(250.0)
    assert load_reader("session_prefill_ms_per_ktok.serve")(run) == (
        pytest.approx(1e6 * 0.5 / (4 * 768)))


def test_readers_without_a_trace_read_nothing():
    run = _serve_run([0.4], [256], 1.0)
    run.update(trace=None, counters=None)
    for name in ("device_idle.serve", "flash_fwd_roofline.serve"):
        assert load_reader(name)(run) is None
    assert readers.roofline({"trace": {"device_ops": 5, "op_seconds": {}},
                             "counters": {"flash_attention": {}}},
                            "flash_attention", "x") is None


def test_roofline_is_bound_over_device_time():
    shape = (4, 512, 32, 128)
    run = {"trace": {"device_ops": 9, "op_seconds": {
        "void flash_fwd_wg_kernel<128, true>(CUtensorMap)": 2e-3,
        "void flash_bwd_dq_kernel<128>(float)": 5.0, "elementwise": 1.0}},
        "counters": {"flash_attention": {shape: 10}}}
    from perfbench import costs
    want = 100 * 10 * costs.kernel_cost("flash_attention")(
        shape, 2)["bound_s"] / 2e-3
    assert load_reader("flash_fwd_roofline.serve")(run) == pytest.approx(
        want)


def test_prefill_mfu_is_the_windows_flops_over_its_seconds():
    from perfbench import costs
    from perfbench.reference import chatglm
    cfg = cases.full_config()
    run = _serve_run([0.4, 0.6, 0.5], [256, 1024, 512], 2.0,
                     ok=[True, True, False])
    run["config"] = cfg
    work = (chatglm.forward_flops(cfg, 4, 256, 4)
            + chatglm.forward_flops(cfg, 4, 1024, 4))
    assert load_reader("prefill_mfu.serve")(run) == pytest.approx(
        100 * work / (2.0 * costs.BF16_FLOPS_PER_S))


def test_traffic_is_a_function_of_the_seed():
    mix = traffic.load(cases.ROOT, "prefill_long")
    tok = traffic.Tokens(65024, mix["tokens"])
    big = 2 ** 31 + 12345
    a = traffic.prompts(mix, tok, big, 7)
    assert np.array_equal(a, traffic.prompts(mix, tok, big, 7))
    assert not np.array_equal(a, traffic.prompts(mix, tok, big + 1, 7)) or \
        a.shape != traffic.prompts(mix, tok, big + 1, 7).shape
    assert len({tuple(r) for r in a}) == a.shape[0]      # rows all differ


def test_every_seed_sends_the_same_lengths_a_cycle():
    mix = traffic.load(cases.ROOT, "prefill_long")
    k = mix["strata"]
    strata = sorted(traffic.length_strata(mix))
    assert strata[0] >= mix["len_min"] and strata[-1] <= mix["len_max"]
    assert all(n % mix["len_step"] == 0 for n in strata)
    for seed in (0, 1, 2 ** 31 + 5, -3):
        for cycle in range(3):
            got = [traffic.prompt_length(mix, seed, cycle * k + j)
                   for j in range(k)]
            assert sorted(got) == strata


def test_serve_readings():
    ref = np.array([[0.0, 2.0, 1.0], [3.0, 0.0, 0.0]])
    got = checks.serve_readings([2, 0], ref + 0.1, ref)
    assert got["token_gap"] == pytest.approx(1.0)
    assert got["logit_dist"] == pytest.approx(
        np.linalg.norm([0.1] * 3) / np.linalg.norm([0.0, 2.0, 1.0]))


def test_judge_holds_each_number_to_its_limit():
    ok, lines = checks.judge({"token_gap": 0.1, "logit_dist": 0.3},
                             {"token_gap": 0.5, "logit_dist": 0.2})
    assert not ok
    assert lines == ["check logit_dist 0.3 limit 0.2 FAILED",
                     "check token_gap 0.1 limit 0.5 ok"]
    ok, _ = checks.judge({"token_gap": 0.1}, {"token_gap": 0.5,
                                              "logit_dist": 0.2})
    assert not ok                      # a number never read fails
