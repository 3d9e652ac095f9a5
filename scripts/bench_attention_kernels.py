#!/usr/bin/env python3
"""Card times of the port's attention kernels (K2, K4, K5, B9, B10, B11) at the served and trained paths'
shapes, for an A/B of two trees.

    python3 scripts/bench_attention_kernels.py [--root TREE ...] [--rounds 1] [--vary FIELD=V1,V2,...]
                                               [--only PREFIX,...]

Each ``--root`` is a checkout of the repository (default: this one).  The trees are timed in turns
within one process (root 1, root 2, ..., then the same in reverse order, ``--rounds`` times), each
from its own ``skrample_tpu_torch`` package and its own kernel build, so that two versions are
compared on one card.  For every shape: the kernel's card time (CUDA-graph replay, L2-warm), its
bound (the larger of its bytes over 3.35 TB/s and its 4*B*H*N^2*d operations over 989 TFLOP/s
bf16), the plain version's card time, the library call's (``F.scaled_dot_product_attention`` on the
same (B, H, N, d) views, with the name of the kernel it dispatched to, read from a trace), and the
wrapper's host time per launch (the median over 200 eager calls, host clock, no synchronize).  Each
kernel is first held against its plain version (atol 5e-3; K4's lse 1e-3).  ``--vary`` times, in a
tree whose plan function exists, the plan with one field forced to each value given (``--vary
stages=2,3`` for ``attention_plan``; ``--vary dkv_stages=2,3,4`` for K5's ``attention_backward_plan``).
``--only K5,B11`` times the cases whose labels start so.  Prints one line a measurement and, last, a
JSON object with every number.

K5 (``flash_attention_qkv_backward``, at the DiT's training shape and its ragged N = 1000) is held to its
plain version (each third within 2e-2 of its largest value) and timed whole, then split by a
torch.profiler trace into its f32 ``delta`` pass, the dq kernel and the dkv kernel; its bound counts
the function's 10*B*H*N^2*d operations and its inputs' and output's bytes, and its library call is
``aten._scaled_dot_product_flash_attention_backward`` on the library forward's outputs.  B11
(``flash_attention_block_stats``, at the ring's hop shapes and Flux's ragged 1152-row block, q a
strided view of a fused qkv, k and v of a fused kv) is held to its plain version (o within 5e-3 plus
one bf16 ulp, m and l 1e-3 relative), bound by 4*B*H*Nq*Nk*d operations, its library call
``aten._scaled_dot_product_flash_attention`` (o and the row logsumexp).
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
BACKWARD_CASES = (("K5 DiT", 4, 4, 1024), ("K5 DiT N 1000", 4, 4, 1000))  # (label, B, H, N) at d 128
K5_GROUPS = (("dq kernel", "flash_bwd_dq"), ("dkv kernel", "flash_bwd_dkv"))  # the rest: the delta pass
# (label, B, H, Nq, Nk, d): the ring DiT-512/8 at sp 1, one hop of its 4-way ring, DiT-384's heads of 64,
# FLUX.1-dev's 4096 + 512 joint tokens over a 4-way ring
BLOCK_STATS_CASES = (
    ("B11 ring DiT", 4, 4, 1024, 1024, 128),
    ("B11 ring hop", 4, 4, 256, 256, 128),
    ("B11 d 64", 4, 6, 1024, 1024, 64),
    ("B11 Flux", 1, 24, 1152, 1152, 128),
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


def split_ms(fn, groups, calls: int = 20) -> dict[str, float]:
    """Card time of one call by kernel group, from a torch.profiler trace of ``calls`` calls: ``groups`` is
    (label, name needle) pairs; a kernel that matches none counts under "other"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            label = next((name for name, needle in groups if needle in e.key), "other")
            out[label] = out.get(label, 0.0) + e.device_time_total / 1e3 / calls
    return out


def plan_variants(fa, plan_fn: str, plan_args: tuple, vary: tuple[str, list[int]] | None) -> list:
    """(suffix, context) pairs to time: the tree's own plan, or, where the tree has ``plan_fn`` and its plan
    the field ``vary`` names, that field forced to each value."""
    if vary and hasattr(fa, plan_fn):
        plan, (field, values) = getattr(fa, plan_fn)(*plan_args), vary
        if field in {f.name for f in dataclasses.fields(plan)}:
            forced = [(v, dataclasses.replace(plan, **{field: v})) for v in values]
            return [(f" {field} {v}", mock.patch.object(fa, plan_fn, lambda *a, f=f: f)) for v, f in forced]
    return [("", contextlib.nullcontext())]


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


def measure(fa, root: Path, results: dict, vary: tuple[str, list[int]] | None, only: tuple[str, ...]) -> None:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(torch.device("cuda")).manual_seed(9)
    for case in CASES:
        label, kind, B, H, N, d = case
        if not label.startswith(only):
            continue
        args, heads = inputs(case, gen)
        kernel, plain = calls(fa, kind, args, H)
        want = plain()
        n_bytes = 4 * B * N * H * d * 2 + (B * H * N * 4 if kind == "lse" else 0)
        bound = max(n_bytes / HBM_BYTES_PER_S, 4.0 * B * H * N * N * d / PEAK_BF16_FLOPS) * 1e3
        iters = 5 if N > 2048 else 20
        row = results.setdefault(label, {"shape": [B, H, N, d], "bound_ms": bound})
        for suffix, patch in plan_variants(fa, "attention_plan", (N, d), vary):
            key = f"{root}{suffix}"
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
    measure_backward(fa, root, results, vary, only)
    measure_block_stats(fa, root, results, vary, only)


def measure_backward(fa, root: Path, results: dict, vary: tuple[str, list[int]] | None, only: tuple[str, ...]):
    "K5's rows: whole, split by kernel, against its bound, plain version and library call."
    import torch

    aten = torch.ops.aten
    gen = torch.Generator(torch.device("cuda")).manual_seed(10)
    for label, B, H, N in BACKWARD_CASES:
        if not label.startswith(only):
            continue
        d = 128
        qkv = torch.randn((B, N, 3 * H * d), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn((B, N, H * d), generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = fa.flash_attention_qkv_forward_lse(qkv, H)
        q, k, v = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)
        fwd = aten._scaled_dot_product_flash_attention(q, k, v)
        lib_args = (g.view(B, N, H, d).transpose(1, 2), q, k, v, fwd[0], fwd[1], *fwd[2:6], 0.0, False, *fwd[6:8])
        kernel = lambda: fa.flash_attention_qkv_backward(qkv, o, lse, g, H)  # noqa: E731
        plain = lambda: fa._qkv_backward_reference(qkv, o, lse, g, H)  # noqa: E731
        want = plain()
        n_bytes = (qkv.numel() + o.numel() + g.numel() + qkv.numel()) * 2 + lse.numel() * 4
        bound = max(n_bytes / HBM_BYTES_PER_S, 10.0 * B * H * N * N * d / PEAK_BF16_FLOPS) * 1e3
        row = results.setdefault(label, {"shape": [B, H, N, d], "bound_ms": bound})
        for suffix, patch in plan_variants(fa, "attention_backward_plan", (N, d), vary):
            key = f"{root}{suffix}"
            with patch:
                got = kernel()
                torch.cuda.synchronize()
                err = max(
                    (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                    for a, b in zip(got.chunk(3, -1), want.chunk(3, -1))
                )
                if err > 2e-2:
                    raise SystemExit(f"{label} at {key}: a third's error {err} of its largest value")
                row.setdefault(key, []).append(graph_ms(kernel, 20))
                row.setdefault(f"{key} host_us", []).append(host_us(kernel))
                split = split_ms(kernel, K5_GROUPS)
                row.setdefault(f"{key} split", []).append(split)
                row[f"relative_err {key}"] = err
            parts = ", ".join(f"{name} {ms * 1e3:.2f}" for name, ms in sorted(split.items()))
            print(f"{label} {(B, H, N, d)} [{key}]: {row[key][-1] * 1e3:.2f} us ({parts} us, traced), host "
                  f"{row[f'{key} host_us'][-1]:.1f} us/launch; bound {bound * 1e3:.2f} us; worst third {err:.3e}")
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(plain, 5)
            library = lambda: aten._scaled_dot_product_flash_attention_backward(*lib_args)  # noqa: E731
            row["library_ms"] = graph_ms(library, 20)
            row["library_kernels"] = traced_kernels(library)
            print(f"{label}: plain {row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us "
                  f"({', '.join(name[:80] for name in row['library_kernels'])})")
        del qkv, g, o, lse, q, k, v, fwd, lib_args, want


def measure_block_stats(fa, root: Path, results: dict, vary: tuple[str, list[int]] | None, only: tuple[str, ...]):
    "B11's rows against their bound, plain version and library call."
    import torch

    gen = torch.Generator(torch.device("cuda")).manual_seed(11)
    for label, B, H, Nq, Nk, d in BLOCK_STATS_CASES:
        if not label.startswith(only):
            continue
        q = torch.randn((B, Nq, 3 * H * d), generator=gen, device="cuda").to(torch.bfloat16)[..., : H * d]
        kv = torch.randn((B, Nk, 2 * H * d), generator=gen, device="cuda").to(torch.bfloat16)
        q = q.reshape(B, Nq, H, d).transpose(1, 2)
        k, v = (t.reshape(B, Nk, H, d).transpose(1, 2) for t in kv.chunk(2, dim=-1))
        kernel = lambda: fa.flash_attention_block_stats(q, k, v)  # noqa: E731
        plain = lambda: fa._block_stats_reference(q, k, v)  # noqa: E731
        ro, rm, rl = plain()
        n_bytes = (2 * B * H * Nq * d + 2 * B * H * Nk * d) * 2 + 2 * B * H * Nq * 4
        bound = max(n_bytes / HBM_BYTES_PER_S, 4.0 * B * H * Nq * Nk * d / PEAK_BF16_FLOPS) * 1e3
        row = results.setdefault(label, {"shape": [B, H, Nq, Nk, d], "bound_ms": bound})
        for suffix, patch in plan_variants(fa, "attention_plan", (Nq, d), vary):
            key = f"{root}{suffix}"
            with patch:
                o, m, l = kernel()
                torch.cuda.synchronize()
                used = ((o.float() - ro.float()).abs() / (5e-3 + 2**-8 * ro.float().abs())).max().item()
                stats = max((a - b).abs().max().item() / b.abs().max().item() for a, b in ((m, rm), (l, rl)))
                if used > 1 or stats > 1e-3:
                    raise SystemExit(f"{label} at {key}: o {used} of its bound, m/l {stats}")
                row.setdefault(key, []).append(graph_ms(kernel, 20))
                row.setdefault(f"{key} host_us", []).append(host_us(kernel))
                row[f"o_bound_used {key}"] = used
            print(f"{label} {(B, H, Nq, Nk, d)} [{key}]: {row[key][-1] * 1e3:.2f} us, host "
                  f"{row[f'{key} host_us'][-1]:.1f} us/launch; bound {bound * 1e3:.2f} us; o {used:.3f} of its "
                  f"bound, m/l {stats:.2e}")
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(plain, 10)
            library = lambda: torch.ops.aten._scaled_dot_product_flash_attention(q, k, v)  # noqa: E731
            row["library_ms"] = graph_ms(library, 20)
            row["library_kernels"] = traced_kernels(library)
            print(f"{label}: plain {row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us "
                  f"({', '.join(name[:80] for name in row['library_kernels'])})")
        del q, kv, k, v, ro, rm, rl


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", type=Path, help="a tree to time (repeatable; default: this one)")
    parser.add_argument("--rounds", type=int, default=1, help="forward-then-reverse passes over the trees")
    parser.add_argument("--vary", help="FIELD=V1,V2,...: time the plan with FIELD forced to each value")
    parser.add_argument("--only", default="", help="PREFIX,...: time only the cases whose labels start so")
    args = parser.parse_args()
    only = tuple(args.only.split(",")) if args.only else ("",)
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
            measure(modules[root], root, results, vary, only)
    print(json.dumps({"card": card, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
