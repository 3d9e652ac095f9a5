"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package never runs a denoise step op by op: the loop is one
``lax.scan``, the continuous engine's tick one jitted scan, the training
step one jitted function.  Here each of those paths is a plain function of
tensors, run eagerly on the CPU and, on the card, captured once as a CUDA
graph over static buffers and replayed: one launch of the whole graph
instead of hundreds of launches from Python.

:class:`CapturedGraph` follows PyTorch's capture recipe: the function runs
``warmup`` times on a side stream first (each launcher's one-time setup,
cuBLAS's workspace, an optimizer's lazy state), then once more under
``torch.cuda.graph``.  Inputs are copied into the static buffers before
each replay, and the outputs are the same tensors every time: a caller
copies what it keeps before the next replay.  Capture is thread-local
(``capture_error_mode="thread_local"``), so a serving worker may capture
while other threads read results back.

The kernels' launch counters count Python calls, and a replay makes none:
:class:`LaunchTally` records each counter's change during the capture,
rolls the counters back (the capture ran nothing), and adds the change
again on every replay.  The warm-up passes are real work and count as
they run.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any

import torch

_TALLIES = ("routes", "modes")
"Per-wrapper dictionaries of launches by route or mode, kept beside ``launches``."


def counted() -> list[Callable]:
    "Every kernel wrapper that counts its launches (looked up at call time, so a patched-out wrapper drops out)."
    from . import adaln, flash_attention, fused, fused_conv, groupnorm, quant, rope

    wrappers = (
        fused.fused_step_cuda,
        flash_attention.flash_attention_qkv_forward,
        adaln.adaln_forward,
        flash_attention.flash_attention_qkv_forward_lse,
        flash_attention.flash_attention_qkv_backward,
        adaln.adaln_backward,
        quant.quantize_rows,
        rope.rope_qk_norm_forward,
        groupnorm.groupnorm_forward,
        flash_attention.flash_attention_pairs_forward,
        fused_conv.conv3x3_gn_silu_forward,
        flash_attention.flash_attention_forward,
        flash_attention.flash_attention_packed_forward,
        fused_conv.tconv_causal_gn_silu_forward,
        flash_attention.flash_attention_block_stats,
    )
    return [fn for fn in wrappers if hasattr(fn, "launches")]


type Snapshot = dict[Callable, tuple[int, dict[str, dict[str, int]]]]


def snapshot() -> Snapshot:
    "Every counter's value now: ``launches`` and the route or mode tallies."
    return {
        fn: (fn.launches, {name: dict(getattr(fn, name)) for name in _TALLIES if hasattr(fn, name)})
        for fn in counted()
    }


class LaunchTally:
    "The launches a captured region made, to be added again on every replay of it."

    def __init__(self, before: Snapshot, after: Snapshot):
        self.deltas: Snapshot = {}
        for fn, (launches, tallies) in after.items():
            base, base_tallies = before.get(fn, (launches, tallies))
            changed = {
                name: {key: count - base_tallies.get(name, {}).get(key, 0) for key, count in tally.items()}
                for name, tally in tallies.items()
            }
            if launches != base:
                self.deltas[fn] = (launches - base, changed)

    @classmethod
    def record(cls, region: Callable[[], Any]) -> tuple[Any, LaunchTally]:
        "Run ``region`` (a capture: nothing runs on the card), note what it counted, and roll the counters back."
        before = snapshot()
        result = region()
        tally = cls(before, snapshot())
        for fn, (launches, tallies) in before.items():
            fn.launches = launches
            for name, tally_before in tallies.items():
                getattr(fn, name).update(tally_before)
        return result, tally

    def replay(self) -> None:
        "Add the region's launches once: one replay of the graph ran them."
        for fn, (launches, tallies) in self.deltas.items():
            fn.launches += launches
            for name, changed in tallies.items():
                tally = getattr(fn, name)
                for key, count in changed.items():
                    tally[key] = tally.get(key, 0) + count

    def per_replay(self) -> dict[str, int]:
        "Launches a replay makes, by wrapper name."
        return {fn.__name__: launches for fn, (launches, _) in self.deltas.items()}


def leaves(tree: Any) -> Iterator[torch.Tensor]:
    "The tensors of a tree of tuples, lists and dicts, in order; None is an empty subtree."
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for key in tree:
            yield from leaves(tree[key])
    elif isinstance(tree, tuple | list):
        for item in tree:
            yield from leaves(item)
    elif tree is not None:
        raise TypeError(f"graph inputs are tensors in tuples, lists and dicts, not {type(tree).__name__}")


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    "``fn`` on every leaf of a tree of tuples, lists and dicts, in the same structure; None stays None."
    if isinstance(tree, dict):
        return {key: map_tree(fn, value) for key, value in tree.items()}
    if isinstance(tree, tuple | list):
        return type(tree)(map_tree(fn, item) for item in tree)
    return None if tree is None else fn(tree)


def require_cuda(tree: Any, what: str) -> torch.device:
    "The CUDA device every tensor of ``tree`` lies on, or ValueError: a graph is never quietly replaced by eager work."
    devices = {t.device for t in leaves(tree)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        where = ", ".join(sorted(str(d) for d in devices)) or "no tensor"
        raise ValueError(
            f"{what}: graph=True captures a CUDA graph; its tensors must lie on one CUDA device, not {where}"
        )
    return next(iter(devices))


class CapturedGraph:
    """``fn(*static)`` captured as one CUDA graph.

    ``static`` are the buffers the graph reads (tensors in tuples, lists and
    dicts); ``fn`` may also update them in place (the continuous engine's
    slot state, a model's parameters).  Construction runs ``fn`` ``warmup``
    times on a side stream (real work: its outputs are ``warmup_output``),
    then captures it; ``output`` is what the captured call returned, which
    every replay rewrites in place."""

    def __init__(self, fn: Callable[..., Any], static: tuple, warmup: int = 1, what: str = "graph"):
        if warmup < 1:
            raise ValueError("a capture needs at least one warm-up pass (lazy setup must not be captured)")
        device = require_cuda(static, what)
        self.static = static
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(warmup):
                out = fn(*static)
        current.wait_stream(side)
        for t in leaves(out):
            t.record_stream(current)  # made on the side stream, read on the caller's
        self.warmup_output = out

        def capture() -> Any:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                return fn(*static)

        self.output, self.tally = LaunchTally.record(capture)

    def replay(self) -> Any:
        "Run the graph on the static buffers as they are now; returns ``output``."
        self.graph.replay()
        self.tally.replay()
        return self.output

    def __call__(self, *inputs: Any) -> Any:
        "Copy ``inputs`` (the same tree as ``static``) into the static buffers, then replay."
        dst, src = list(leaves(self.static)), list(leaves(inputs))
        if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src, strict=True)):
            raise ValueError("graph inputs differ from the captured ones in structure or shape")
        for d, s in zip(dst, src, strict=True):
            if d is not s:
                d.copy_(s)
        return self.replay()
