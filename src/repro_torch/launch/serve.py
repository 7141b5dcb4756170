"""Serving: batched prefill + greedy decode under EnTK management.

Each request batch is an EnTK task (``reg://serve_batch``) run by
:class:`~repro_torch.rts.torch_rts.TorchRTS` on one device: prefill the
prompt batch, then decode ``max_new_tokens`` greedily. Failed batches are
resubmitted by the toolkit, as in the JAX package.

Prefill on the card goes through the CUDA kernels of the model's family
(their plain versions on the CPU): flash attention and the Mamba-2 SSD scan
for zamba2, the RWKV-6 WKV for rwkv6, flash attention once a layer for the
attention stack (dense). Weights are random, drawn on the device at the
configuration's widths from a seed: no published checkpoint is in the
repository. Prompts are token ids, as in the JAX package: a configuration
that takes embeddings (vlm, audio) runs through
:mod:`repro_torch.models.steps` instead, and the command line serves
stablelm-12b in its place.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b --device cpu
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import telemetry as tel
from ..core import AppManager, Pipeline, Stage, Task, register_executable
from ..device import DeviceLike, device_name, resolve_device
from ..kernels import KERNELS
from ..models import steps as steps_mod, transformer
from ..models.config import get_config
from ..rts.base import ResourceDescription
from ..rts.torch_rts import TorchRTS


_SESSIONS: Dict[str, "ServeSession"] = {}
_SESSIONS_LOCK = threading.Lock()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeSession:
    """One model's weights and step functions on one device. ``params``
    (bf16 matmul weights, the JAX serving layout) may be given; otherwise
    they are drawn on the device from seed 0. ``stats`` keeps one record
    per :meth:`generate` call."""

    def __init__(self, arch: str, smoke: bool = True,
                 device: DeviceLike = None,
                 params: Optional[Dict] = None) -> None:
        self.device = resolve_device(device)
        self.cfg = get_config(arch, smoke=smoke)
        t0 = time.perf_counter()
        self.params = params if params is not None else \
            transformer.init_params(self.cfg, 0, torch.bfloat16, self.device)
        _sync(self.device)
        self.build_seconds = time.perf_counter() - t0
        self.prefill = steps_mod.make_prefill_step(self.cfg)
        self.decode = steps_mod.make_decode_step(self.cfg)
        self.stats: List[Dict] = []

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16
                 ) -> np.ndarray:
        """prompts: (B, S) int → (B, max_new_tokens) int32 greedy (ties
        take the first maximal index, as ``jnp.argmax`` does).

        The stats record's kernel launch counts are the change of the
        wrappers' global counts over this call: exact when one batch runs
        at a time on the device, as :func:`run_managed` runs them."""
        with tel.span("serve.generate", "serve"):
            cfg, dev = self.cfg, self.device
            B, S = prompts.shape
            with tel.span("serve.upload", "serve"):
                inputs = torch.as_tensor(np.asarray(prompts),
                                         dtype=torch.int32)
                batch = {"inputs": inputs.to(dev)}
                if cfg.rope_variant == "mrope":
                    pos = torch.arange(S, dtype=torch.int32,
                                       device=dev).expand(B, S)
                    batch["positions"] = pos[:, None].expand(B, 3, S)
            launches = {name: fn.launches for name, fn in KERNELS.items()}
            t0 = time.perf_counter()
            # the step's call to its return: the host's dispatch of its ops
            with tel.span("serve.prefill", "serve"):
                logits, cache = self.prefill(self.params, batch)
            # move the prefill cache into one with room for the new tokens
            with tel.span("serve.cache", "serve"):
                full = _merge_cache(
                    transformer.init_cache(cfg, B, S + max_new_tokens, dev),
                    cache)
            with tel.span("serve.sync", "serve"):
                prefill_finite = torch.isfinite(logits).all()
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
                _sync(dev)
            t1 = time.perf_counter()
            launched = {f"{name}_launches": fn.launches - launches[name]
                        for name, fn in KERNELS.items()}
            out = [tok]
            with tel.span("serve.decode", "serve"):
                decode_finite = torch.ones((), dtype=torch.bool, device=dev)
                for _ in range(max_new_tokens - 1):
                    logits, full = self.decode(self.params, tok, full)
                    decode_finite &= torch.isfinite(logits).all()
                    tok = torch.argmax(logits, dim=-1)[:, None].to(
                        torch.int32)
                    out.append(tok)
            with tel.span("serve.answer", "serve"):
                tokens = torch.cat(out, dim=1).cpu().numpy()
            t2 = time.perf_counter()
            steps = max_new_tokens - 1
            self.stats.append({
                "batch": B, "prompt_len": S, "new_tokens": max_new_tokens,
                "prefill_s": t1 - t0,
                "decode_s_per_token": (t2 - t1) / steps if steps else None,
                "prefill_logits_finite": bool(prefill_finite),
                "decode_logits_finite": bool(decode_finite),
                **launched,
            })
            return tokens


def _merge_cache(dst, src):
    if isinstance(dst, dict):
        return {k: _merge_cache(dst[k], src[k]) if k in src else dst[k]
                for k in dst}
    if not isinstance(dst, torch.Tensor):
        return src                      # "length": a Python int
    if dst.shape == src.shape:
        return src.to(dst.dtype)
    dst[tuple(slice(0, s) for s in src.shape)] = src.to(dst.dtype)
    return dst


def get_session(arch: str, smoke: bool = True,
                device: DeviceLike = None) -> ServeSession:
    """The process's session for (arch, smoke, device), built once: the
    lock keeps two concurrent batches from building two copies of the
    weights."""
    dev = device_name(device)
    key = f"{arch}:{smoke}:{dev}"
    with _SESSIONS_LOCK:
        if key not in _SESSIONS:
            _SESSIONS[key] = ServeSession(arch, smoke, device=dev)
        return _SESSIONS[key]


def serve_batch(arch: str, smoke: bool, prompts: List[List[int]],
                max_new_tokens: int = 8, device: Optional[str] = None
                ) -> List[List[int]]:
    sess = get_session(arch, smoke, device)
    out = sess.generate(np.asarray(prompts, np.int32), max_new_tokens)
    return out.tolist()


register_executable("serve_batch", serve_batch)


def run_managed(arch: str, n_batches: int = 4, batch_size: int = 4,
                prompt_len: int = 16, max_new_tokens: int = 8,
                smoke: bool = True, device: DeviceLike = None,
                timeout: float = 600.0) -> AppManager:
    """Serve ``n_batches`` request batches as one EnTK stage on one
    device (``cuda`` unless ``device="cpu"``)."""
    dev = device_name(device)
    rng = np.random.default_rng(0)
    cfg = get_config(arch, smoke=smoke)
    pipe = Pipeline(f"serve-{arch}")
    st = Stage("requests")
    for b in range(n_batches):
        prompts = rng.integers(
            0, cfg.vocab_size, (batch_size, prompt_len)).tolist()
        st.add_tasks(Task(
            name=f"batch{b}", executable="reg://serve_batch",
            kwargs={"arch": arch, "smoke": smoke, "prompts": prompts,
                    "max_new_tokens": max_new_tokens, "device": dev},
            max_retries=1))
    pipe.add_stages(st)
    amgr = AppManager(resources=ResourceDescription(slots=2),
                      rts_factory=lambda: TorchRTS(device=dev))
    amgr.workflow = [pipe]
    amgr.run(timeout=timeout)
    return amgr


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke config)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--new-tokens", type=int, default=8)
    args = ap.parse_args()
    arch = args.arch
    if get_config(arch, smoke=True).embedding_inputs:
        print(f"{arch} takes embedding inputs; using token-input arch "
              "stablelm-12b for the CLI demo")
        arch = "stablelm-12b"
    t0 = time.time()
    amgr = run_managed(arch, n_batches=args.batches,
                       batch_size=args.batch_size,
                       max_new_tokens=args.new_tokens, smoke=not args.full,
                       device=args.device)
    results = [t.result for p in amgr.workflow
               for s in p.stages for t in s.tasks]
    print(f"served {len(results)} batches in {time.time()-t0:.1f}s; "
          f"all DONE: {amgr.all_done}")
    print("sample generation:", results[0][0] if results[0] else None)


if __name__ == "__main__":
    main()
