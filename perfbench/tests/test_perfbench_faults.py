"""A run of the cell on the CPU at smoke size, past the harness's look for
a chip, with the timed path broken underneath: ``correct`` has to come out
false for every fault the cell can have (an answer altered where it is
produced; the cell runs on one card and has no step state to leave
unchanged)."""

import pytest
import torch

from perfbench import run as bench_run
from perfbench.tests import cases


def _run(workload=cases.PREFILL, seconds=0.5, trace=False, **kw):
    return bench_run.run_cell(
        workload, cases.SEED, seconds, trace, torch.device("cpu"),
        smoke=True, config=cases.config(workload),
        mix=cases.mix(workload), cell=cases.cell(workload), **kw)["line"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_served_token_altered_is_not_correct(monkeypatch):
    from repro_torch.launch import serve
    generate = serve.ServeSession.generate

    def altered(self, prompts, max_new_tokens=16):
        out = generate(self, prompts, max_new_tokens)
        return (out + 1) % self.cfg.vocab_size
    monkeypatch.setattr(serve.ServeSession, "generate", altered)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["token_gap"]["value"] > (
        line["checks"]["token_gap"]["limit"])


def test_sound_prefill_run_gives_every_number():
    """Unbroken, the same small run gives every number, finite."""
    line = _run()
    assert list(line)[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] > 0
    assert all(v["value"] == v["value"] and v["value"] < float("inf")
               for v in line["checks"].values())


def test_logits_of_another_request_are_not_correct(monkeypatch):
    """The answer altered where it is produced: every batch answered from
    its prompts in reverse order."""
    from repro_torch.launch import serve
    generate = serve.ServeSession.generate

    def reversed_prompts(self, prompts, max_new_tokens=16):
        return generate(self, prompts[:, ::-1].copy(), max_new_tokens)
    monkeypatch.setattr(serve.ServeSession, "generate", reversed_prompts)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["logit_dist"]["value"] > (
        line["checks"]["logit_dist"]["limit"])


def test_a_traced_run_reads_every_per_layer_metric_it_can_on_the_cpu():
    """With --trace 1 the line carries the per-layer metrics that need no
    device (the device's own read nothing on the CPU)."""
    line = _run(trace=True)
    got = set(line["metrics"])
    assert {"entk_overhead_ms.serve", "session_prefill_ms_per_ktok.serve",
            "prefill_mfu.serve"} <= got
    assert "serve_tokens_per_s" not in got
