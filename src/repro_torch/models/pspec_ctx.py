"""Activation-sharding context: divisibility-guarded constraints.

The JAX package pins activations with ``with_sharding_constraint`` inside
a context the launch layer enters around tracing; the port does the same
for DTensors. The launch layer (:mod:`repro_torch.launch.dryrun`) enters

    with activation_ctx(mesh, param_pspecs):
        step(state, batch)

and inside model code ``constrain(x, "dp", None, "tp", None)`` then
redistributes a DTensor so that its batch dim lies on the data axes and
(when the dim divides the axis) its head or FF dim on the model axis.
Without it DTensor's per-op sharding propagation is free to leave large
intermediates replicated or partial.

Outside a context, and for a plain tensor, :func:`constrain` returns its
argument untouched: one context-variable read, so the one-device paths
(the tests, the card's serve and train paths) pay nothing that shows.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    dp: Union[str, Tuple[str, ...], None]
    tp: Optional[str]
    dp_size: int
    tp_size: int
    # path string → PSpec of the parameters (cast before gather)
    param_specs: Optional[dict] = None
    mesh: Any = None

    def param_spec(self, path_str: str):
        if self.param_specs is None:
            return None
        return self.param_specs.get(path_str)


_CTX: contextvars.ContextVar[Optional[AxisCtx]] = contextvars.ContextVar(
    "repro_torch_axis_ctx", default=None)


def path_str(path) -> str:
    """A parameter's keys from the root, joined by ``/`` (as JAX's
    ``path_str`` joins a pytree path)."""
    return "/".join(str(p) for p in path)


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


@contextlib.contextmanager
def activation_ctx(mesh, param_pspecs=None):
    """``mesh``: a :class:`repro_torch.launch.mesh.Mesh` (its
    ``device_mesh`` is what DTensors are redistributed on).
    ``param_pspecs``: optional PSpec dict of the model's parameters; when
    given, :func:`repro_torch.models.transformer.cast_for_compute` keeps
    each bf16 compute copy on its f32 master's sharding, so the cast runs
    on-shard and the gather moves bf16."""
    names = mesh.axis_names
    dp_names = tuple(n for n in ("pod", "data") if n in names)
    dp: Union[str, Tuple[str, ...], None]
    dp = dp_names if len(dp_names) > 1 else (dp_names[0] if dp_names
                                             else None)
    dp_size = math.prod(mesh.shape[n] for n in dp_names)
    tp = "model" if "model" in names else None
    tp_size = mesh.shape.get("model", 1) if tp else 1
    if getattr(mesh, "device_mesh", None) is not None:
        from ..kernels._library import register_sharding
        register_sharding()     # the kernel ops' DTensor rules
    spec_map = None
    if param_pspecs is not None:
        spec_map = {path_str(p): s for p, s in _flatten(param_pspecs)}
    token = _CTX.set(AxisCtx(dp, tp, dp_size, tp_size, spec_map, mesh))
    try:
        yield
    finally:
        _CTX.reset(token)


def active() -> Optional[AxisCtx]:
    return _CTX.get()


def guarded_spec(c: AxisCtx, shape, tokens) -> tuple:
    """The spec ``constrain`` pins: tokens per dim, "dp" (batch axes),
    "tp" (model axis) or None; a token drops to None when the dim does not
    divide its axis, so the same model code serves one device and 512."""
    spec = []
    for dim, t in zip(shape, tokens):
        if t == "dp" and c.dp is not None and c.dp_size > 1 \
                and dim % c.dp_size == 0:
            spec.append(c.dp)
        elif t == "tp" and c.tp is not None and c.tp_size > 1 \
                and dim % c.tp_size == 0:
            spec.append(c.tp)
        else:
            spec.append(None)
    spec.extend([None] * (len(shape) - len(spec)))
    return tuple(spec)


class _Pin(torch.autograd.Function):
    """Redistribute to ``placements`` forward, and the gradient to the
    same placements backward: JAX transposes a sharding constraint into
    the same constraint on the cotangent, where DTensor's own redistribute
    sends the gradient back to the input's placements and leaves the
    backward's layout to per-op propagation."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def _redistribute(x, spec, mesh, pin_grad: bool = True):
    from ..models.sharding import PSpec, to_placements
    placements = to_placements(PSpec(*spec), mesh)
    if pin_grad and torch.is_grad_enabled() and x.requires_grad:
        return _Pin.apply(x, placements)     # the gradient too, always
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def is_dtensor(x) -> bool:
    """``x`` is a DTensor under an activation context (False outside any
    context, without a look at ``x``)."""
    if _CTX.get() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *tokens, pin_grad: bool = True):
    """Apply a guarded sharding constraint: ``x`` itself outside a context
    or when it is a plain tensor, else ``x`` redistributed to the guarded
    spec (:func:`guarded_spec`), and its gradient to the same spec in the
    backward (as JAX transposes a constraint). ``pin_grad=False`` leaves
    the gradient to DTensor (back to ``x``'s own placements): a residual
    branch's sequence-sharded output, whose gradient feeds the branch's
    last matmul, which cannot take a flattened (batch, sequence) shard."""
    c = _CTX.get()
    if c is None or not is_dtensor(x):
        return x
    return _redistribute(x, guarded_spec(c, x.shape, tokens), c.mesh,
                         pin_grad)


def constrain_to(x, spec):
    """``x`` redistributed to ``spec`` (a PSpec) under a context, when it
    is a DTensor; else ``x`` itself."""
    c = _CTX.get()
    if c is None or spec is None or not is_dtensor(x):
        return x
    return _redistribute(x, tuple(spec), c.mesh)


def gather_for_compute(tree):
    """A layer's parameters as its compute reads them: each DTensor
    leaf's data-axis (FSDP) shards gathered, its model-axis shards kept.
    Called inside the layer's checkpoint region, so the gathered copy is
    one layer's and is gathered again in the backward, as FSDP does.
    Outside a context: ``tree`` itself."""
    c = _CTX.get()
    if c is None:
        return tree
    from torch.distributed.tensor import Replicate
    dp_names = {"pod", "data"}

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if not is_dtensor(x):
            return x
        names = c.mesh.axis_names
        placements = tuple(Replicate() if n in dp_names else p
                           for n, p in zip(names, x.placements))
        if placements == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, placements)
    return one(tree)


def _placements(c: AxisCtx, tokens) -> tuple:
    """Placements of a token spec ("dp", "tp" or None per dim) whose dims
    the caller knows divide their axes."""
    from ..models.sharding import PSpec, to_placements
    spec = [c.dp if t == "dp" and c.dp_size > 1 else
            c.tp if t == "tp" and c.tp_size > 1 else None for t in tokens]
    return to_placements(PSpec(*spec), c.mesh)


def local(fn, in_specs, out_specs):
    """``fn`` run on each rank's local shards: under a context whose mesh
    has a device mesh, ``local_map`` of ``fn`` (DTensor arguments
    redistributed to ``in_specs``, one token spec an argument; outputs
    wrapped with ``out_specs``, a list of token specs, or one spec for a
    single output); ``fn`` itself otherwise."""
    c = _CTX.get()
    if c is None or getattr(c.mesh, "device_mesh", None) is None:
        return fn
    from torch.distributed.tensor.experimental import local_map
    # local_map reads a tuple as one entry an output, a list as one
    # output's placements
    outs = (tuple(list(_placements(c, s)) for s in out_specs)
            if isinstance(out_specs, list)
            else list(_placements(c, out_specs)))
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(list(_placements(c, s))
                                         for s in in_specs),
                     device_mesh=c.mesh.device_mesh,
                     redistribute_inputs=True)


def unstack(x):
    """``x.unbind(0)``: a stacked parameter's per-layer slices. A DTensor
    sharded on its layer axis (the FSDP rule's dim -2 of a stacked
    vector, as in JAX) is gathered on that axis first."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        placements = tuple(Replicate() if p == Shard(0) else p
                           for p in x.placements)
        if placements != tuple(x.placements):
            x = x.redistribute(x.device_mesh, placements)
    return x.unbind(0)


def run_local(fn, p, x, state):
    """``fn(p, x, state)`` → (x', state'), one recurrent layer's decode
    step. Under an activation context with DTensors each device runs it
    on its own batch rows with the layer's parameters gathered whole (a
    one-token step of a scan has no sequence to shard, and its head
    reshapes want every head); the outputs lie batch on the data axes.
    Otherwise ``fn`` itself."""
    c = _CTX.get()
    if c is None or not is_dtensor(x):
        return fn(p, x, state)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim

    def rows(t):
        return list(_placements(c, ("dp",) if t.shape[0] % c.dp_size == 0
                                else (None,)))

    def local(t, placements):
        return (t.redistribute(mesh, placements).to_local()
                if is_dtensor(t) else t)

    def tree(d, f):
        return {k: tree(v, f) if isinstance(v, dict) else f(v)
                for k, v in d.items()}
    out, new = fn(tree(p, lambda t: local(t, whole)), local(x, rows(x)),
                  tree(state, lambda t: local(t, rows(t))))

    def wrap(t, like):
        return DTensor.from_local(t, mesh, rows(like), run_check=False)
    return wrap(out, x), {k: wrap(v, state[k]) for k, v in new.items()}


def vocab_gold(logits, labels):
    """The gold logits of vocab-sharded DTensor logits (B, c, V): each
    device gathers the labels inside its vocab slice (zero elsewhere) and
    the result is a partial sum over the model axis, as vocab-parallel
    cross-entropy runs. (DTensor's own gather of sharded logits builds a
    gradient of the global logits' size.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    c = _CTX.get()
    V = logits.shape[-1]
    tp = c.tp is not None and c.tp_size > 1 and V % c.tp_size == 0
    rows = c.dp is not None and c.dp_size > 1 and \
        logits.shape[0] % c.dp_size == 0
    v_local = V // c.tp_size if tp else V
    dm = c.mesh.device_mesh
    offset = dm.get_local_rank(c.tp) * v_local if tp else 0
    dp_names = {"pod", "data"}
    names = c.mesh.axis_names

    def pl(vocab):
        return [(Shard(0) if rows else Replicate()) if n in dp_names
                else (vocab if n == c.tp and tp else Replicate())
                for n in names]

    def gold(lg, lb):
        idx = lb.long() - offset
        inside = (idx >= 0) & (idx < v_local)
        g = torch.gather(lg, -1, idx.clamp(0, v_local - 1)[..., None])
        return g[..., 0] * inside.to(lg.dtype)
    return local_map(gold, out_placements=pl(Partial()),
                     in_placements=(pl(Shard(2)), pl(Replicate())),
                     device_mesh=dm, redistribute_inputs=True)(logits,
                                                               labels)
