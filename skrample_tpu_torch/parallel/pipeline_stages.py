"""GPipe pipeline parallelism over a ``pp`` mesh axis.

The JAX package's schedule (``skrample_tpu/parallel/pipeline_stages.py``):
the ``M`` microbatches flow through ``S`` stages, stage ``s`` running
microbatch ``t - s`` at tick ``t`` of ``M + S - 1``, the activation handed to
the next stage after each tick; the carry is a pytree (a DiT's ``(tokens,
temb)``, an MMDiT's ``(img, txt, cond)``), and ``batch_axis`` composes pp with
dp (each ``dp`` slice runs its own pipeline over the same stage weights).

The port is explicit SPMD: each rank of the ``pp`` axis is one stage and
holds its own stage's parameters.  Activations move by point-to-point
send/receive over the rank's ``pp`` group, one hop a microbatch and stage:
a stage receives microbatch ``m`` from the stage before it, runs it, and
sends it on, so stage ``s`` works on microbatch ``t - s`` at tick ``t`` as
in the JAX loop.  A stage that holds no real microbatch at a tick (the fill
and the drain) computes nothing; the JAX loop computes garbage there that
it never reads, so the outputs are the same.  The last stage's outputs are
broadcast over ``pp`` (the JAX package's closing ``psum``): every stage
rank returns them.

With a gradient, the whole schedule is one :class:`torch.autograd.Function`
a call: its backward runs the microbatches in reverse, each hop sending
the activation's gradient back one stage, and hands the inputs' gradient
(stage 0's) to every stage rank.  The outputs' gradient is read on the last
stage alone: every stage rank computes the same loss from the same outputs,
as every device of the JAX mesh sees one loss.  A stage's parameters get
their gradient on that stage's rank only.  Every hop, and the stage work
between them, runs under :func:`~.faults.guarded`: a fault on one stage
aborts the group, so its peers raise within the group's timeout.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch
import torch.distributed as dist

from ._comm import broadcast, p2p
from .faults import guarded
from .ring_attention import axis_group

__all__ = ["model_stages", "pipeline_apply", "run_stages", "stack_stages"]


# ---- pytrees of tensors: dicts (sorted keys, as jax flattens them), lists and tuples --------------


def _flatten(tree: Any) -> tuple[list[Any], Any]:
    "``(leaves, structure)``: dict keys sorted, list and tuple items in order."
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return [leaf for leaves, _ in parts for leaf in leaves], ("dict", keys, [s for _, s in parts])
    if isinstance(tree, list | tuple):
        parts = [_flatten(item) for item in tree]
        return [leaf for leaves, _ in parts for leaf in leaves], (type(tree), None, [s for _, s in parts])
    return [tree], None


def _unflatten(structure: Any, leaves: Sequence[Any]) -> Any:
    "The inverse of :func:`_flatten`."
    it = iter(leaves)

    def build(node: Any) -> Any:
        if node is None:
            return next(it)
        kind, keys, children = node
        items = [build(child) for child in children]
        return dict(zip(keys, items)) if kind == "dict" else kind(items)

    return build(structure)


def stack_stages(block_params: list, stages: int) -> Any:
    """Stack a depth-list of per-block parameter trees into stage-major leaves: each leaf gets a
    leading ``(stages, depth // stages)`` pair of axes, stage ``s`` holding the consecutive blocks
    ``[s * depth/stages, (s+1) * depth/stages)``.  :func:`pipeline_apply` hands each stage rank its
    own ``leaf[s]``."""
    depth = len(block_params)
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible into {stages} pipeline stages")
    per = depth // stages
    flat = [_flatten(block) for block in block_params]
    structure = flat[0][1]
    stacked = [torch.stack([torch.as_tensor(leaves[i]) for leaves, _ in flat]) for i in range(len(flat[0][0]))]
    return _unflatten(structure, [leaf.reshape(stages, per, *leaf.shape[1:]) for leaf in stacked])


def pipeline_apply(
    stage_fn: Callable[[Any, Any], Any],
    stage_params: Any,
    microbatches: Any,
    mesh: Any,
    axis: str = "pp",
    batch_axis: str | None = None,
) -> Any:
    """Run ``microbatches`` through the S stages of mesh axis ``axis``.

    ``stage_params``: a tree whose leaves have a leading stage axis of size S (:func:`stack_stages`);
    this rank's stage reads ``leaf[stage]``.  ``microbatches``: a tree of ``(M, mb, ...)`` leaves,
    the same on every stage rank.  ``stage_fn(params, carry)`` maps one microbatch's tree through one
    stage, keeping its structure, shapes and dtypes.  Returns the last stage's ``(M, mb, ...)``
    outputs on every stage rank.  ``batch_axis`` (e.g. ``"dp"``): the mesh axis the microbatches'
    item dim is split over; each rank passes its own ``(M, mb / dp, ...)`` part and gets its part of
    the outputs back, and its ``pp`` line runs its own pipeline (no collective over ``batch_axis``)."""
    group, stages, stage = axis_group(mesh, axis)
    if batch_axis is not None:
        axis_group(mesh, batch_axis)  # raises on a mesh without the axis
    leaves, structure = _flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != stages:
            raise ValueError(f"a stage parameter leaf of shape {tuple(leaf.shape)} has no leading {stages}-stage axis")

    def local_fn(params: list[torch.Tensor], carry: Any) -> Any:
        return stage_fn(_unflatten(structure, [leaf[stage] for leaf in params]), carry)

    return run_stages(local_fn, leaves, microbatches, group)


def model_stages(
    blocks: Sequence[Any], mesh: Any, axis: str, batch_axis: str | None, batch: int, microbatch: int
) -> tuple[list[Any], int, dist.ProcessGroup]:
    """A model's pipelined apply: ``(this stage's blocks, this rank's microbatch size, the pp
    group)``.  The blocks split into consecutive stages; ``microbatch`` counts items of the whole
    batch and, with ``batch_axis``, divides into the axis' chunks (``batch``: this rank's items)."""
    group, stages, stage = axis_group(mesh, axis)
    if len(blocks) % stages:
        raise ValueError(f"depth {len(blocks)} not divisible into {stages} pipeline stages")
    per = len(blocks) // stages
    if batch_axis is not None:
        _group, size, _rank = axis_group(mesh, batch_axis)
        if microbatch % size:
            raise ValueError(f"microbatch {microbatch} not divisible by the {batch_axis!r} axis size ({size})")
        microbatch //= size
    if batch % microbatch:
        raise ValueError(f"batch {batch} not divisible into microbatches of {microbatch}")
    return list(blocks[stage * per : (stage + 1) * per]), microbatch, group


class _Plan:
    "What one pipeline call's forward and backward share."

    def __init__(self, fn: Callable, structure: Any, count: int, group: Any, floats: list[bool]) -> None:
        self.fn, self.structure, self.count, self.group, self.floats = fn, structure, count, group, floats
        self.size, self.stage = dist.get_world_size(group), dist.get_rank(group)
        self.prev = dist.get_global_rank(group, self.stage - 1) if self.stage > 0 else None
        self.next = dist.get_global_rank(group, self.stage + 1) if self.stage < self.size - 1 else None
        self.first, self.last = dist.get_global_rank(group, 0), dist.get_global_rank(group, self.size - 1)


def run_stages(
    fn: Callable[[list[torch.Tensor], Any], Any],
    params: Sequence[torch.Tensor],
    microbatches: Any,
    group: dist.ProcessGroup,
) -> Any:
    """The schedule of :func:`pipeline_apply` over ``group`` (this rank's stage is its rank there):
    ``fn(params, carry)`` is this stage's work on one microbatch, ``params`` this stage's own
    tensors (a model passes its stage's parameters as they are, no stacking)."""
    leaves, structure = _flatten(microbatches)
    plan = _Plan(fn, structure, leaves[0].shape[0], group, [leaf.is_floating_point() for leaf in leaves])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*params, *leaves)):
        outs = _Pipeline.apply(plan, len(params), *params, *leaves)
    else:
        outs = _forward(plan, list(params), leaves, None)
    return _unflatten(structure, list(outs))


def _hop(plan: _Plan, m: int, tensors: list[torch.Tensor], peer: int, send: bool) -> Callable[[], None]:
    "Post microbatch ``m``'s sends (or receives) with ``peer``, a tag a leaf; returns the wait."
    ops = [(t, peer, m * len(plan.floats) + i) for i, t in enumerate(tensors)]
    return p2p(ops, [], plan.group) if send else p2p([], ops, plan.group)


def _forward(plan: _Plan, params: list[torch.Tensor], leaves: list[torch.Tensor], keep: list | None) -> list:
    """The fill-run-drain forward on this stage; with ``keep`` (a gradient wanted) each microbatch's
    inputs and outputs are kept with their graph.  Returns the last stage's outputs, broadcast."""
    pending: list = []
    outputs: list[list[torch.Tensor]] = []
    with guarded([plan.group]):
        for m in range(plan.count):
            if plan.prev is None:
                x = [leaf[m] for leaf in leaves]
            else:
                x = [torch.empty_like(leaf[m], memory_format=torch.contiguous_format) for leaf in leaves]
                _hop(plan, m, x, plan.prev, send=False)()
            if keep is None:
                y = _flatten(plan.fn(params, _unflatten(plan.structure, x)))[0]
            else:
                x = [t.detach().requires_grad_(f) for t, f in zip(x, plan.floats)]
                with torch.enable_grad():
                    y = _flatten(plan.fn(params, _unflatten(plan.structure, x)))[0]
                keep.append((x, y))
            for out, leaf in zip(y, leaves):
                if out.shape != leaf.shape[1:] or out.dtype != leaf.dtype:
                    raise ValueError(
                        f"a stage maps a {leaf.dtype} {tuple(leaf.shape[1:])} leaf to {out.dtype} {tuple(out.shape)}: "
                        "stage_fn must keep the carry's shapes and dtypes"
                    )
            if plan.next is None:
                outputs.append([t.detach() for t in y])
            else:
                pending.append(_hop(plan, m, [t.detach().contiguous() for t in y], plan.next, send=True))
        for wait in pending:
            wait()
        if plan.next is None:
            result = [torch.stack([out[i] for out in outputs]) for i in range(len(leaves))]
        else:
            result = [torch.empty_like(leaf) for leaf in leaves]
        for t in result:
            broadcast(t, plan.last, plan.group)
    return result


class _Pipeline(torch.autograd.Function):
    """:func:`_forward` with a gradient: the backward runs the microbatches in reverse, receiving each
    output's gradient from the next stage (the last stage reads its own), differentiating the kept
    graph, and sending the input's gradient back one stage; stage 0's input gradients reach every
    stage rank by a broadcast."""

    @staticmethod
    def forward(ctx, plan: _Plan, n_params: int, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
        params, leaves = list(tensors[:n_params]), list(tensors[n_params:])
        keep: list = []
        result = _forward(plan, params, leaves, keep)
        ctx.plan, ctx.keep, ctx.params = plan, keep, params
        ctx.wants = [t.requires_grad for t in leaves]
        ctx.shapes = [leaf.shape for leaf in leaves]
        ctx.mark_non_differentiable(*(t for t, f in zip(result, plan.floats) if not f))
        return tuple(result)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        plan, keep, params = ctx.plan, ctx.keep, ctx.params
        floats = [i for i, f in enumerate(plan.floats) if f]
        trained = [i for i, p in enumerate(params) if p.requires_grad]
        param_grads: list[torch.Tensor | None] = [None] * len(params)
        input_grads = [keep[0][0][i].new_zeros(shape) if f else None
                       for i, (shape, f) in enumerate(zip(ctx.shapes, plan.floats))]
        pending: list = []
        with guarded([plan.group]):
            for m in reversed(range(plan.count)):
                x, y = keep[m]
                if plan.next is None:
                    dy = [grads[i][m] for i in floats]
                else:
                    dy = [torch.empty_like(y[i], memory_format=torch.contiguous_format) for i in floats]
                    _hop(plan, m, dy, plan.next, send=False)()
                outs = [(y[i], g) for i, g in zip(floats, dy) if y[i].requires_grad]
                wrt = [x[i] for i in floats] + [params[j] for j in trained]
                found = torch.autograd.grad([o for o, _ in outs], wrt, [g for _, g in outs], allow_unused=True)
                dx = [torch.zeros_like(x[i]) if g is None else g for i, g in zip(floats, found[: len(floats)])]
                for j, g in zip(trained, found[len(floats):]):
                    if g is not None:
                        param_grads[j] = g if param_grads[j] is None else param_grads[j] + g
                if plan.prev is None:
                    for i, g in zip(floats, dx):
                        input_grads[i][m] = g
                else:
                    pending.append(_hop(plan, m, [g.contiguous() for g in dx], plan.prev, send=True))
            for wait in pending:
                wait()
            for i in floats:
                broadcast(input_grads[i], plan.first, plan.group)
        ctx.keep = ctx.params = None
        inputs = [g if want else None for g, want in zip(input_grads, ctx.wants)]
        return (None, None, *param_grads, *inputs)
