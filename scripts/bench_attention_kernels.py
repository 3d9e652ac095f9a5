#!/usr/bin/env python3
"""Card times of the port's forward attention kernels (K2, K4, B9, B10) at the served paths' shapes, for an
A/B of two trees.

    python3 scripts/bench_attention_kernels.py [--root TREE ...] [--rounds 1] [--vary FIELD=V1,V2,...]

Each ``--root`` is a checkout of the repository (default: this one).  The trees are timed in turns
within one process (root 1, root 2, ..., then the same in reverse order, ``--rounds`` times), each
from its own ``skrample_tpu_torch`` package and its own kernel build, so that two versions are
compared on one card.  For every shape: the kernel's card time (CUDA-graph replay, L2-warm), its
bound (the larger of its bytes over 3.35 TB/s and its 4*B*H*N^2*d operations over 989 TFLOP/s
bf16), the plain version's card time, the library call's (``F.scaled_dot_product_attention`` on the
same (B, H, N, d) views, with the name of the kernel it dispatched to, read from a trace), and the
wrapper's host time per launch (the median over 200 eager calls, host clock, no synchronize).  Each
kernel is first held against its plain version (atol 5e-3; K4's lse 1e-3).  ``--vary`` times, in a
tree whose ``attention_plan`` exists, the plan with one field forced to each value given (``--vary
stages=2,3``; ``block_q=64,128`` on a tree that instantiates 64-row blocks).  Prints one line a
measurement and, last, a JSON object with every number.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# (label, wrapper, B, H, N, d): the paths' shapes (Flux K2, the SDXL UNet's B10 and its head-dim-32 B9b
# route, the DiT's K2 and K4, DiT-384's B9a)
CASES = (
    ("K2 Flux", "qkv", 1, 24, 4608, 128),
    ("B9b packed", "packed", 2, 5, 4096, 128),
    ("B10 pairs", "pairs", 4, 10, 4096, 64),
    ("K2 DiT", "qkv", 4, 4, 1024, 128),
    ("B9a DiT-384", "bhnd", 4, 6, 1024, 64),
    ("K4 DiT", "lse", 4, 4, 1024, 128),
)


def graph_ms(fn, iters: int) -> float:
    "Card time of one call: ``iters`` calls captured in one CUDA graph, replayed, timed by events."
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 200) -> float:
    "The median host time of one eager call (the enqueue, no synchronize), in microseconds."
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if len(times) % 20 == 0:
            torch.cuda.synchronize()  # keep the launch queue short
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def traced_kernels(fn) -> list[str]:
    "The names of the kernels one call launched on the card, from a torch.profiler trace."
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA})


def load_tree(root: Path):
    "The ``flash_attention`` module of the tree at ``root``, with its own kernel build directory."
    import os

    for name in [m for m in sys.modules if m == "skrample_tpu_torch" or m.startswith("skrample_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    os.environ["SKRAMPLE_TPU_TORCH_BUILD"] = str(root / "build" / "skrample_tpu_torch")
    try:
        module = importlib.import_module("skrample_tpu_torch.ops.flash_attention")
        cuda = importlib.import_module("skrample_tpu_torch.ops._cuda")
        t0 = time.perf_counter()
        cuda.library()
        print(f"{root}: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    finally:
        sys.path.remove(str(root))
    return module


def inputs(case, gen):
    "One fused qkv tensor of the case and its views: (qkv, (q, k, v) as the wrapper takes them, (B, H, N, d) views)."
    import torch

    _, kind, B, H, N, d = case
    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    heads = tuple(t.reshape(B, N, H, d).transpose(1, 2) for t in (q, k, v))
    args = {"qkv": (qkv,), "lse": (qkv,), "packed": (q, k, v), "pairs": (q, k, v), "bhnd": heads}[kind]
    return args, heads


def calls(fa, kind: str, args: tuple, H: int):
    "The kernel's call and its plain version's."
    if kind == "qkv":
        return lambda: fa.flash_attention_qkv_forward(args[0], H), lambda: fa._qkv_reference(args[0], H)
    if kind == "lse":
        return lambda: fa.flash_attention_qkv_forward_lse(args[0], H), lambda: fa._qkv_reference_lse(args[0], H)
    if kind == "packed":
        return lambda: fa.flash_attention_packed_forward(*args, H), lambda: fa._packed_reference(*args, H)
    if kind == "pairs":
        return lambda: fa.flash_attention_pairs_forward(*args, H), lambda: fa._packed_reference(*args, H)
    return lambda: fa.flash_attention_forward(*args), lambda: fa.attention_reference(*args)


def check(label: str, root: Path, kind: str, got, want) -> float:
    "The kernel's largest error against its plain version; exits past atol 5e-3 (K4's lse 1e-3)."
    if kind == "lse":
        lse_err = (got[1] - want[1]).abs().max().item()
        if lse_err > 1e-3:
            raise SystemExit(f"{label} at {root}: lse error {lse_err} against the plain version")
        got, want = got[0], want[0]
    err = (got.float() - want.float()).abs().max().item()
    if err > 5e-3:
        raise SystemExit(f"{label} at {root}: error {err} against the plain version")
    return err


def measure(fa, root: Path, results: dict, vary: tuple[str, list[int]] | None) -> None:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(torch.device("cuda")).manual_seed(9)
    for case in CASES:
        label, kind, B, H, N, d = case
        args, heads = inputs(case, gen)
        kernel, plain = calls(fa, kind, args, H)
        want = plain()
        n_bytes = 4 * B * N * H * d * 2 + (B * H * N * 4 if kind == "lse" else 0)
        bound = max(n_bytes / HBM_BYTES_PER_S, 4.0 * B * H * N * N * d / PEAK_BF16_FLOPS) * 1e3
        iters = 5 if N > 2048 else 20
        row = results.setdefault(label, {"shape": [B, H, N, d], "bound_ms": bound})
        variants = [("", None)]
        if vary and hasattr(fa, "attention_plan"):
            plan, (field, values) = fa.attention_plan(N, d), vary
            variants = [(f" {field} {v}", dataclasses.replace(plan, **{field: v})) for v in values]
        for suffix, forced in variants:
            key = f"{root}{suffix}"
            patch = mock.patch.object(fa, "attention_plan", lambda n, dd, f=forced: f) if forced else contextlib.nullcontext()
            with patch:
                try:
                    got = kernel()
                except RuntimeError as refused:  # a forced plan the entry point does not take
                    print(f"{label} [{key}]: refused ({refused})")
                    continue
                torch.cuda.synchronize()
                err = check(label, root, kind, got, want)
                row.setdefault(key, []).append(graph_ms(kernel, iters))
                row.setdefault(f"{key} host_us", []).append(host_us(kernel))
                row[f"max_abs_err {key}"] = err
            print(f"{label} {(B, H, N, d)} [{key}]: {row[key][-1] * 1e3:.2f} us, host "
                  f"{row[f'{key} host_us'][-1]:.1f} us/launch; bound {bound * 1e3:.2f} us; err {err:.3e}")
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(plain, iters)
            if kind == "lse":  # the flash attention that also returns the row logsumexp
                library = lambda h=heads: torch.ops.aten._scaled_dot_product_flash_attention(*h)  # noqa: E731
            else:
                library = lambda h=heads: F.scaled_dot_product_attention(*h)  # noqa: E731
            row["library_ms"] = graph_ms(library, iters)
            row["library_kernels"] = traced_kernels(library)
            print(f"{label}: plain {row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us "
                  f"({', '.join(name[:80] for name in row['library_kernels'])})")
        del args, heads, want


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", type=Path, help="a tree to time (repeatable; default: this one)")
    parser.add_argument("--rounds", type=int, default=1, help="forward-then-reverse passes over the trees")
    parser.add_argument("--vary", help="FIELD=V1,V2,...: time the plan with FIELD forced to each value")
    args = parser.parse_args()
    vary = None
    if args.vary:
        field, values = args.vary.split("=")
        vary = (field, [int(v) for v in values.split(",")])
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the card times need the card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    roots = [r.resolve() for r in (args.root or [Path(__file__).resolve().parent.parent])]
    modules = {root: load_tree(root) for root in roots}
    results: dict = {}
    for _ in range(args.rounds):
        for root in roots + roots[::-1]:
            measure(modules[root], root, results, vary)
    print(json.dumps({"card": card, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
