#!/usr/bin/env python3
"""Card times of the port's conv kernels (B12 bf16, B13) at the served paths' shapes, for an A/B of two trees.

    python3 scripts/bench_conv_kernels.py [--root TREE ...] [--rounds 2]

Each ``--root`` is a checkout of the repository (default: this one).  The trees are timed in turns
within one process (root 1, root 2, ..., then the same in reverse order, ``--rounds`` times), each
from its own ``skrample_tpu_torch`` package and its own kernel build, so that two versions are
compared on one card.  For every shape: the kernel's card time (CUDA-graph replay, L2-warm), its
bound (the larger of its bytes over 3.35 TB/s and its operations over 989 TFLOP/s bf16), the plain
version's and the library call's card times (``F.conv2d`` / ``F.conv3d`` on the input normalized
beforehand: the conv alone, TF32 off), and the wrapper's host time per launch (the median over 200
eager calls, host clock, no synchronize).  Each kernel is first held against its plain version
(relative 1e-2).  Prints one line a measurement and, last, a JSON object with every number.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# (label, (N, H, W, C), Co, norm, affine, residual, statistics): the fused decodes' and the UNets' bf16 3x3 convs
B12_CASES = (
    ("sdxl unet 640", (2, 64, 64, 640), 640, False, False, False, False),
    ("sdxl unet 320", (2, 128, 128, 320), 320, False, False, False, False),
    ("sdxl unet 1280", (2, 32, 32, 1280), 1280, False, False, False, False),
    ("gn+affine+res 512", (1, 256, 256, 512), 512, True, True, True, True),
    ("bare 512", (1, 256, 256, 512), 512, False, False, False, False),  # the row above without its norm
    ("video finest gn+res", (16, 512, 512, 64), 64, True, False, True, True),
    ("video finest bare", (16, 512, 512, 64), 64, False, False, False, False),
    ("video out_conv", (16, 512, 512, 64), 3, False, False, False, False),
)
# (label, (B, T, S, C), Co, mode, repeat): the video decode's temporal convs
B13_CASES = (
    ("finest gn+res", (1, 16, 262144, 64), 64, "residual", 1),
    ("finest bare", (1, 16, 262144, 64), 64, "bare", 1),  # the row above without its norm and residual
    ("repeat", (1, 8, 65536, 128), 128, "repeat", 2),
    ("mid gn", (1, 4, 4096, 256), 256, "stats", 1),
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


def load_tree(root: Path):
    "The ``fused_conv`` module of the tree at ``root``, with its own kernel build directory."
    import os

    for name in [m for m in sys.modules if m == "skrample_tpu_torch" or m.startswith("skrample_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    os.environ["SKRAMPLE_TPU_TORCH_BUILD"] = str(root / "build" / "skrample_tpu_torch")
    try:
        module = importlib.import_module("skrample_tpu_torch.ops.fused_conv")
        cuda = importlib.import_module("skrample_tpu_torch.ops._cuda")
        t0 = time.perf_counter()
        cuda.library()
        print(f"{root}: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    finally:
        sys.path.remove(str(root))
    return module


def b12_inputs(fc, case, gen):
    import torch

    _, shape, co, norm, affine, residual, _ = case
    N, H, W, C = shape
    dev = torch.device("cuda")
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
    w = (torch.randn((3, 3, C, co), generator=gen, device=dev) / (3 * C**0.5)).to(torch.bfloat16)
    b = 0.1 * torch.randn(co, generator=gen, device=dev)
    stats = res = scale = bias = None
    if norm:
        stats = fc.finalize_group_stats(fc.channel_stats(x), min(32, C // 2), H * W)
    if affine:
        scale = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bias = 0.1 * torch.randn(C, generator=gen, device=dev)
    if residual:
        res = torch.randn((N, H, W, co), generator=gen, device=dev).to(torch.bfloat16)
    return x, w, b, stats, res, scale, bias


def b13_inputs(fc, case, gen):
    import torch

    _, shape, co, mode, rep = case
    B, T, S, C = shape
    dev = torch.device("cuda")
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
    w = torch.randn((3, C, co), generator=gen, device=dev) / (3 * C) ** 0.5
    b = 0.1 * torch.randn(co, generator=gen, device=dev)
    stats = res = None
    if mode in ("residual", "stats"):
        stats = fc.finalize_group_stats(fc.channel_stats(x.reshape(B * T, S, C)), 16, S).reshape(B, T, 2, C)
    if mode == "residual":
        res = torch.randn((B, T, S, co), generator=gen, device=dev).to(torch.bfloat16)
    return x, w, b, stats, res, rep


def measure(fc, root: Path, results: dict) -> None:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(torch.device("cuda")).manual_seed(8)
    for case in B12_CASES:
        label, shape, co, norm, affine, residual, with_stats = case
        N, H, W, C = shape
        args = b12_inputs(fc, case, gen)
        x, w, b, stats, res, scale, bias = args
        got, raw = fc.conv3x3_gn_silu_forward(*args, out_stats=with_stats)
        want, want_raw = fc.conv3x3_ref(*args)
        torch.cuda.synchronize()
        rel = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if with_stats:
            rel = max(rel, (raw - want_raw).abs().max().item() / want_raw.abs().max().item())
        if rel > 1e-2:
            raise SystemExit(f"B12 {label} at {root}: relative error {rel} against the plain version")
        flops = 2.0 * N * H * W * 9 * C * co
        n_bytes = (x.numel() + w.numel() + got.numel() + (res.numel() if residual else 0)) * 2 + co * 4
        if norm:
            n_bytes += (stats.numel() + (2 * C if affine else 0)) * 4
        if with_stats:
            n_bytes += raw.numel() * 4
        bound = max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        xin = x
        if norm:
            xin = fc._normalize_silu(x.float(), stats[:, None, None, 0, :], stats[:, None, None, 1, :], scale, bias)
            xin = xin.to(x.dtype)
        x_lib = xin.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = b.to(x.dtype)
        iters = 5 if flops > 2e11 else 20

        def kernel(a=args, s=with_stats):
            return fc.conv3x3_gn_silu_forward(*a, out_stats=s)

        def library(a=(x_lib, w_lib, b_lib)):
            with fc.cudnn_tf32(False):
                return F.conv2d(a[0], a[1], a[2], 1, 1)

        row = results.setdefault(f"B12 {label}", {"shape": list(shape), "co": co, "bound_ms": bound})
        row.setdefault(str(root), []).append(graph_ms(kernel, iters))
        row.setdefault(f"{root} host_us", []).append(host_us(kernel))
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(lambda a=args: fc.conv3x3_ref(*a), iters)
            row["library_ms"] = graph_ms(library, iters)
        row["max_rel_err " + str(root)] = rel
        print(f"B12 {label} {shape}->{co} [{root}]: {row[str(root)][-1] * 1e3:.2f} us, host "
              f"{row[f'{root} host_us'][-1]:.1f} us/launch; bound {bound * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us; rel err {rel:.3e}")
        del args, x, w, got, want, xin, x_lib, res
    for case in B13_CASES:
        label, shape, co, mode, rep = case
        B, T, S, C = shape
        args = b13_inputs(fc, case, gen)
        x, w, b, stats, res, _ = args
        got, raw = fc.tconv_causal_gn_silu_forward(*args)
        want, want_raw = fc.tconv_causal_ref(*args)
        torch.cuda.synchronize()
        rel = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        rel = max(rel, (raw - want_raw).abs().max().item() / want_raw.abs().max().item())
        if rel > 1e-2:
            raise SystemExit(f"B13 {label} at {root}: relative error {rel} against the plain version")
        T_out = T * rep
        flops = 2.0 * B * T_out * S * 3 * C * co
        n_bytes = (x.numel() + 3 * C * co + got.numel() + (res.numel() if res is not None else 0)) * 2 + co * 4
        n_bytes += raw.numel() * 4 + (stats.numel() * 4 if stats is not None else 0)
        bound = max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        xin = x
        if stats is not None:
            xin = fc._normalize_silu(x.float(), stats[:, :, None, 0, :], stats[:, :, None, 1, :]).to(x.dtype)
        if rep > 1:
            xin = xin.repeat_interleave(rep, dim=1)
        x_lib = xin.view(B, T_out, S, 1, C).permute(0, 4, 1, 2, 3)
        w_lib = w.to(x.dtype).permute(2, 1, 0)[..., None, None].contiguous(memory_format=torch.channels_last_3d)
        b_lib = b.to(x.dtype)
        iters = 5 if flops > 5e10 else 20

        def kernel(a=args):
            return fc.tconv_causal_gn_silu_forward(*a)

        row = results.setdefault(f"B13 {label}", {"shape": list(shape), "co": co, "bound_ms": bound})
        row.setdefault(str(root), []).append(graph_ms(kernel, iters))
        row.setdefault(f"{root} host_us", []).append(host_us(kernel))
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(lambda a=args: fc.tconv_causal_ref(*a), iters)
            row["library_ms"] = graph_ms(lambda a=(x_lib, w_lib, b_lib): F.conv3d(a[0], a[1], a[2], padding=(2, 0, 0)), iters)
        row["max_rel_err " + str(root)] = rel
        print(f"B13 {label} {shape}->{co} [{root}]: {row[str(root)][-1] * 1e3:.2f} us, host "
              f"{row[f'{root} host_us'][-1]:.1f} us/launch; bound {bound * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us; rel err {rel:.3e}")
        del args, x, w, got, want, xin, x_lib, res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", type=Path, help="a tree to time (repeatable; default: this one)")
    parser.add_argument("--rounds", type=int, default=1, help="forward-then-reverse passes over the trees")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the card times need the card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    roots = [r.resolve() for r in (args.root or [Path(__file__).resolve().parent.parent])]
    modules = {root: load_tree(root) for root in roots}
    results: dict = {}
    for _ in range(args.rounds):
        for root in roots + roots[::-1]:
            measure(modules[root], root, results)
    print(json.dumps({"card": card, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
