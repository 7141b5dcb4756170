"""A serving cell: request batches as EnTK tasks (``reg://serve_batch``,
run by ``AppManager`` on ``TorchRTS``), from one client in a closed loop.

Set-up draws the served weights on the card from the seed and hands them
to a ``ServeSession``, registered as the session ``serve_batch`` finds;
the session's prefill step is wrapped so that the logits each request was
answered from are kept. Each prompt length the mix sends is warmed once,
and the EnTK path once. In the window, each batch is one stage of one
pipeline; when a stage ends, its ``post_exec`` (the client) takes the
answer and, while the window lasts, appends the next batch, which is due
at that moment. The window closes with the first batch that ends after
``--seconds``. Once the session is freed, the plain reference computes
the logits of a sample of the answered batches, drawn from the seed with
the longest among them, and the two are compared.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from . import checks, traffic, weights
from .. import reference
from .trace import profiled, span


def check_sizes(cfg: Dict, program: Dict) -> None:
    """Raise unless every size the program runs is the file's."""
    diff = {k: (cfg[k], v) for k, v in program.items() if cfg[k] != v}
    if diff:
        raise RuntimeError(f"the program runs other sizes than "
                           f"{cfg['name']}'s file (file, program): {diff}")


def _counters() -> Dict:
    """Every kernel's calls by shape, as the program counts them."""
    from repro_torch.kernels import KERNELS
    return {name: dict(fn.shapes) for name, fn in KERNELS.items()}


def _delta(after: Dict, before: Dict) -> Dict:
    return {k: {s: n - before[k].get(s, 0) for s, n in v.items()
                if n - before[k].get(s, 0)} for k, v in after.items()}


class Client:
    """One client of a closed loop: one batch in flight; the next is due
    when the last is answered."""

    def __init__(self, ctx, tokens: traffic.Tokens, deadline_s: float,
                 max_batches: int = 10 ** 9, ready: int = 0) -> None:
        self.ctx, self.tokens = ctx, tokens
        self.deadline_s, self.max_batches = deadline_s, max_batches
        self.batches: List[Dict] = []
        self.t0 = 0.0
        # the client holds its requests before it sends them: the first
        # ``ready`` are drawn now, any beyond them when they are sent
        self.ready = [self.request(i) for i in range(ready)]

    def request(self, index: int) -> List[List[int]]:
        return traffic.prompts(self.ctx.mix, self.tokens, self.ctx.seed,
                               index).tolist()

    def stage(self, index: int):
        from repro_torch.core import Stage, Task
        ctx = self.ctx
        prompts = (self.ready[index] if index < len(self.ready)
                   else self.request(index))
        st = Stage(f"batch{index}", post_exec=self.answered)
        st.add_tasks(Task(
            name=f"batch{index}", executable="reg://serve_batch",
            kwargs={"arch": ctx.arch, "smoke": ctx.smoke,
                    "prompts": prompts,
                    "max_new_tokens": ctx.mix["max_new_tokens"],
                    "device": str(ctx.device)},
            max_retries=ctx.mix.get("max_retries", 0)))
        self.batches.append({"index": index, "due": time.perf_counter(),
                             "length": len(prompts[0]),
                             "rows": len(prompts), "task": st.tasks[0]})
        return st

    def answered(self, stage, pipeline) -> None:
        now = time.perf_counter()
        rec = self.batches[-1]
        rec["done"] = now
        task = rec.pop("task")
        rec["ok"] = task.state == "DONE" and task.result is not None
        rec["served"] = task.result
        if (now - self.t0 < self.deadline_s
                and len(self.batches) < self.max_batches):
            pipeline.add_stages(self.stage(len(self.batches)))

    def run(self) -> float:
        """Serve until the deadline; returns the window's seconds."""
        from repro_torch.core import AppManager, Pipeline
        from repro_torch.rts.base import ResourceDescription
        from repro_torch.rts.torch_rts import TorchRTS
        dev = str(self.ctx.device)
        amgr = AppManager(resources=ResourceDescription(slots=1),
                          rts_factory=lambda: TorchRTS(device=dev))
        pipe = Pipeline("perfbench-serve")
        self.t0 = time.perf_counter()
        pipe.add_stages(self.stage(len(self.batches)))
        amgr.workflow = [pipe]
        with span("entk_run"):
            amgr.run(timeout=self.ctx.seconds + 600.0)
        return self.batches[-1]["done"] - self.t0


def run(ctx) -> Dict:
    from repro_torch.launch import serve as serve_mod
    from repro_torch.device import device_name
    from repro_torch.models import transformer

    cfg, mix, seed, dev = ctx.config, ctx.mix, ctx.seed, ctx.device
    ref = reference.load(cfg["reference"])
    spec = ref.param_spec(cfg)
    params = weights.make(spec, seed, dev, torch.bfloat16)
    arch = ctx.arch = cfg["arch"]
    sess = serve_mod.ServeSession(arch, smoke=ctx.smoke, device=dev,
                                  params=params)
    del params
    weights.check_layout(spec, transformer.abstract_params(
        sess.cfg, torch.bfloat16), torch.bfloat16)
    check_sizes(cfg, ref.program_sizes(sess.cfg))
    kept: List[torch.Tensor] = []
    prefill = sess.prefill

    def keeping_prefill(p, batch):
        with span("session_prefill"):
            logits, cache = prefill(p, batch)
        kept.append(logits)
        return logits, cache
    sess.prefill = keeping_prefill
    key = f"{arch}:{ctx.smoke}:{device_name(dev)}"
    serve_mod._SESSIONS[key] = sess

    tokens = traffic.Tokens(ref.vocab_size(cfg), mix["tokens"])
    # warm every length the mix sends, then the EnTK path once
    strata = traffic.length_strata(mix)
    t0 = time.perf_counter()
    for n in sorted(set(strata)):
        warm = tokens.rows(seed, 0xA11 + n, mix["batch"], n)
        sess.generate(warm, mix["max_new_tokens"])
    ctx.sync()
    per_token = (time.perf_counter() - t0) / sum(sorted(set(strata)))
    Client(ctx, tokens, 0.0, max_batches=1).run()
    # the requests a window is expected to send, and half as many again
    expect = ctx.seconds / (per_token * sum(strata) / len(strata))
    client = Client(ctx, tokens, ctx.seconds, ready=int(1.5 * expect) + 8)
    ctx.sync()
    sess.stats.clear()
    kept.clear()
    setup_s = ctx.elapsed()

    traced, counters = None, None
    if ctx.trace:
        before = _counters()
        probe = Client(ctx, tokens, float("inf"),
                       max_batches=mix["trace_batches"])
        with profiled(dev) as traced:
            probe.run()
        counters = _delta(_counters(), before)
        sess.stats.clear()
        kept.clear()

    seconds = client.run()
    ctx.sync()
    batches = client.batches
    stats = list(sess.stats)
    peak = ctx.memory_peak()
    ok = [b for b in batches if b["ok"]]
    for b, st in zip(ok, stats):
        b["prefill_s"] = st["prefill_s"]
    # the sampled batches' logits, to the host before the session goes
    rng = np.random.default_rng([seed % 2 ** 64, 0x5A4])
    longest = max(range(len(ok)), key=lambda i: (ok[i]["length"], -i))
    rest = [i for i in range(len(ok)) if i != longest]
    pick = [longest] + sorted(rng.choice(
        rest, size=min(len(rest), mix["check_batches"] - 1),
        replace=False).tolist())
    sample = [(ok[i]["index"], ok[i]["served"], kept[i].float().cpu().numpy())
              for i in pick]
    window = {"seconds": seconds, "units": len(ok), "batches": batches,
              "tokens": sum(b["rows"] * (b["length"] + mix["max_new_tokens"])
                            for b in ok)}
    serve_mod._SESSIONS.pop(key, None)
    sess.params = None
    del sess, kept[:], prefill
    gc.collect()
    ctx.free()

    t_ref = time.perf_counter()
    reference.exact_f32()
    params = weights.make(spec, seed, dev, torch.bfloat16)
    served, prog, want = [], [], []
    for index, answer, logits in sample:
        ids = torch.from_numpy(traffic.prompts(mix, tokens, seed, index)
                               ).to(dev)
        want.append(ref.last_logits(params, cfg, ids).cpu().numpy())
        served += [row[0] for row in answer]
        prog.append(logits)
    del params
    gc.collect()
    ctx.free()
    readings = checks.serve_readings(served, np.concatenate(prog),
                                     np.concatenate(want))
    return {"setup_s": setup_s, "window": window, "trace": traced,
            "counters": counters, "memory_peak_bytes": peak,
            "attempted": len(batches) * mix["batch"],
            "failed": (len(batches) - len(ok)) * mix["batch"],
            "readings": readings,
            "reference_s": time.perf_counter() - t_ref}
