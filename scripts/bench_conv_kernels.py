#!/usr/bin/env python3
"""Card times of the port's conv-family kernels (B12 bf16 and f32, B13, B8) at the served shapes, to A/B two trees.

    python3 scripts/bench_conv_kernels.py [--root TREE ...] [--rounds 2] [--only PREFIX,...]

Each ``--root`` is a checkout of the repository (default: this one).  The trees are timed in turns
within one process (root 1, root 2, ..., then the same in reverse order, ``--rounds`` times), each
from its own ``skrample_tpu_torch`` package and its own kernel build, so that two versions are
compared on one card.  ``--only`` keeps the cases whose labels start with one of the prefixes
("B12 f32", "B12", "B13", "B8").  For every shape: the kernel's card time (CUDA-graph replay,
L2-warm), its bound (the larger of its bytes over 3.35 TB/s and its operations over the peak of
their type: 989 TFLOP/s bf16; for f32 B12 the smaller of three TF32 products at 494.7 TFLOP/s and
one FFMA product at 67 TFLOP/s), the plain version's and the library call's card times
(``F.conv2d`` / ``F.conv3d`` on the input normalized beforehand: the conv alone, TF32 off;
``F.group_norm`` on the channels-last NCHW tensor, no SiLU), and the wrapper's host time per launch
(the median over 200 eager calls, host clock, no synchronize); B8's time is also split by kernel
from a torch.profiler trace.  Each kernel is first held against its plain version (relative 1e-2;
f32 B12 1e-4, f32 B8 1e-5).  Prints one line a measurement and, last, a JSON object with every
number.
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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import card_time  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_F32_FLOPS = 67e12

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
# (label, (N, H, W, C), Co): the SDXL VAE's fused decode (f32), GN(32) + affine + SiLU on read, a residual,
# the statistics
B12_F32_CASES = (
    ("f32 128", (1, 128, 128, 512), 512),
    ("f32 256", (1, 256, 256, 512), 512),
    ("f32 512", (1, 512, 512, 512), 256),
    ("f32 1024", (1, 1024, 1024, 256), 128),
)
# (label, (B, N, C), dtype, affine, eps): GroupNorm(32) + SiLU, the SDXL UNet's (batch 4: bucket 2 under CFG),
# the UNet family's f32 resnet form, and the SDXL VAE's unfused decode at its finest level (f32)
B8_CASES = (
    ("320", (4, 16384, 320), "bfloat16", True, 1e-5),
    ("960", (4, 4096, 960), "bfloat16", True, 1e-5),
    ("2560", (4, 1024, 2560), "bfloat16", True, 1e-5),
    ("640 f32", (4, 4096, 640), "float32", False, 1e-6),
    ("decode f32", (1, 1048576, 128), "float32", True, 1e-6),
)
B8_GROUPS = (("stats", "gn_stats"), ("finalize", "gn_finalize"), ("apply", "gn_apply"))
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


def split_ms(fn, groups, calls: int = 20) -> dict[str, float]:
    """Card time of one call by kernel group, from a torch.profiler trace of ``calls`` calls: ``groups`` is
    (label, name needle) pairs; a kernel that matches none counts under "other".  The groups' times add up
    to the union of the kernels' spans (``chip_smoke.card_time``): a programmatic dependent launch is
    traced from its launch, and the part of its span under the kernel before it counts for that kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    kernel_ms, _launches, _busy = card_time(prof)
    for kernel, ms in kernel_ms.items():
        label = next((name for name, needle in groups if needle in kernel), "other")
        out[label] = out.get(label, 0.0) + ms / calls
    return out


def load_tree(root: Path, names: tuple[str, ...] = ("ops.fused_conv", "ops.groupnorm")):
    "The ``skrample_tpu_torch`` modules ``names`` of the tree at ``root``, with its own kernel build directory."
    import os

    for name in [m for m in sys.modules if m == "skrample_tpu_torch" or m.startswith("skrample_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    os.environ["SKRAMPLE_TPU_TORCH_BUILD"] = str(root / "build" / "skrample_tpu_torch")
    try:
        modules = tuple(importlib.import_module(f"skrample_tpu_torch.{name}") for name in names)
        cuda = importlib.import_module("skrample_tpu_torch.ops._cuda")
        t0 = time.perf_counter()
        cuda.library()
        print(f"{root}: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    finally:
        sys.path.remove(str(root))
    return modules


def b12_inputs(fc, case, gen, dtype=None):
    import torch

    _, shape, co, norm, affine, residual, _ = case
    dtype = dtype or torch.bfloat16
    N, H, W, C = shape
    dev = torch.device("cuda")
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    w = (torch.randn((3, 3, C, co), generator=gen, device=dev) / (3 * C**0.5)).to(dtype)
    b = 0.1 * torch.randn(co, generator=gen, device=dev)
    stats = res = scale = bias = None
    if norm:
        stats = fc.finalize_group_stats(fc.channel_stats(x), min(32, C // 2), H * W)
    if affine:
        scale = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bias = 0.1 * torch.randn(C, generator=gen, device=dev)
    if residual:
        res = torch.randn((N, H, W, co), generator=gen, device=dev).to(dtype)
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


def measure_b12_f32(fc, root: Path, results: dict, only: tuple[str, ...]) -> None:
    "B12's f32 route at the SDXL VAE decode's shapes: GN + affine + SiLU on read, a residual, the statistics."
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(torch.device("cuda")).manual_seed(11)
    for label, shape, co in B12_F32_CASES:
        label = f"B12 {label}"
        if not label.startswith(only):
            continue
        N, H, W, C = shape
        args = b12_inputs(fc, (label, shape, co, True, True, True, True), gen, torch.float32)
        x, w, b, stats, res, scale, bias = args
        got, raw = fc.conv3x3_gn_silu_forward(*args)
        want, want_raw = fc.conv3x3_ref(*args)
        torch.cuda.synchronize()
        rel = (got - want).abs().max().item() / want.abs().max().item()
        rel = max(rel, (raw - want_raw).abs().max().item() / want_raw.abs().max().item())
        if rel > 1e-4:
            raise SystemExit(f"{label} at {root}: relative error {rel} against the plain version")
        flops = 2.0 * N * H * W * 9 * C * co
        n_bytes = (x.numel() + w.numel() + got.numel() + res.numel()) * 4 + co * 4 + (stats.numel() + 2 * C) * 4
        n_bytes += raw.numel() * 4
        ops = min(3 * flops / PEAK_TF32_FLOPS, flops / PEAK_F32_FLOPS)
        bound = max(n_bytes / HBM_BYTES_PER_S, ops) * 1e3
        xin = fc._normalize_silu(x, stats[:, None, None, 0, :], stats[:, None, None, 1, :], scale, bias)
        x_lib = xin.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def kernel(a=args):
            return fc.conv3x3_gn_silu_forward(*a)

        def library(a=(x_lib, w_lib, b)):
            with fc.cudnn_tf32(False):
                return F.conv2d(a[0], a[1], a[2], 1, 1)

        row = results.setdefault(label, {"shape": list(shape), "co": co, "bound_ms": bound,
                                         "tf32x3_bound_ms": 3 * flops / PEAK_TF32_FLOPS * 1e3,
                                         "ffma_bound_ms": flops / PEAK_F32_FLOPS * 1e3})
        row.setdefault(str(root), []).append(graph_ms(kernel, 5))
        row.setdefault(f"{root} host_us", []).append(host_us(kernel))
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(lambda a=args: fc.conv3x3_ref(*a), 5)
            row["library_ms"] = graph_ms(library, 5)
        row["max_rel_err " + str(root)] = rel
        print(f"{label} {shape}->{co} [{root}]: {row[str(root)][-1] * 1e3:.2f} us "
              f"({flops / row[str(root)][-1] / 1e9:.1f} TFLOP/s), host {row[f'{root} host_us'][-1]:.1f} us/launch; "
              f"bound {bound * 1e3:.2f} us (3xTF32 {row['tf32x3_bound_ms'] * 1e3:.2f}, FFMA "
              f"{row['ffma_bound_ms'] * 1e3:.2f}), plain {row['plain_ms'] * 1e3:.2f} us, library (cuDNN, TF32 off) "
              f"{row['library_ms'] * 1e3:.2f} us; rel err {rel:.3e}")
        del args, x, w, got, want, xin, x_lib, res


def measure_b8(gn, root: Path, results: dict, only: tuple[str, ...]) -> None:
    "B8: GroupNorm(32) + SiLU, whole and split by kernel, against its bytes bound and F.group_norm."
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(torch.device("cuda")).manual_seed(12)
    dev = torch.device("cuda")
    for label, shape, dtype_name, affine, eps in B8_CASES:
        label = f"B8 {label}"
        if not label.startswith(only):
            continue
        dtype = getattr(torch, dtype_name)
        B, N, C = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1.5).to(dtype)
        scale = (1 + 0.1 * torch.randn(C, generator=gen, device=dev)) if affine else None
        bias = 0.1 * torch.randn(C, generator=gen, device=dev) if affine else None
        args = (x, 32, True, eps, scale, bias)
        got = gn.groupnorm_forward(*args)
        want = gn.groupnorm_reference(*args)
        torch.cuda.synchronize()
        rel = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if rel > (1e-5 if dtype == torch.float32 else 2**-7):
            raise SystemExit(f"{label} at {root}: relative error {rel} against the plain version")
        del want
        bound = (2 * x.numel() * x.element_size() + (2 * C * 4 if affine else 0)) / HBM_BYTES_PER_S * 1e3
        side = int(N**0.5)
        nchw = x.view(B, side, side, C).permute(0, 3, 1, 2)
        w_lib = (scale if affine else torch.ones(C, device=dev)).to(dtype)
        b_lib = (bias if affine else torch.zeros(C, device=dev)).to(dtype)

        def kernel(a=args):
            return gn.groupnorm_forward(*a)

        row = results.setdefault(label, {"shape": list(shape), "dtype": dtype_name, "bound_ms": bound})
        row.setdefault(str(root), []).append(graph_ms(kernel, 20))
        row.setdefault(f"{root} host_us", []).append(host_us(kernel))
        split = split_ms(kernel, B8_GROUPS)
        row.setdefault(f"{root} split", []).append(split)
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(lambda a=args: gn.groupnorm_reference(*a), 5)
            lib_args = (nchw, w_lib, b_lib, eps)
            row["library_ms"] = graph_ms(lambda a=lib_args: F.group_norm(a[0], 32, a[1], a[2], a[3]), 20)
        row["max_rel_err " + str(root)] = rel
        parts = ", ".join(f"{name} {ms * 1e3:.2f}" for name, ms in sorted(split.items()))
        print(f"{label} {shape} {dtype_name} [{root}]: {row[str(root)][-1] * 1e3:.2f} us (traced: {parts}), host "
              f"{row[f'{root} host_us'][-1]:.1f} us/launch; bound {bound * 1e3:.2f} us (bytes), plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library (F.group_norm, no SiLU) {row['library_ms'] * 1e3:.2f} us; "
              f"rel err {rel:.3e}")
        del x, got, nchw


def measure(fc, gn, root: Path, results: dict, only: tuple[str, ...]) -> None:
    import torch
    import torch.nn.functional as F

    measure_b12_f32(fc, root, results, only)
    measure_b8(gn, root, results, only)
    gen = torch.Generator(torch.device("cuda")).manual_seed(8)
    for case in B12_CASES:
        label, shape, co, norm, affine, residual, with_stats = case
        if not f"B12 {label}".startswith(only):
            continue
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
        if not f"B13 {label}".startswith(only):
            continue
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
    parser.add_argument("--only", default="", help="PREFIX,...: time only the cases whose labels start so")
    args = parser.parse_args()
    only = tuple(args.only.split(",")) if args.only else ("",)
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
            measure(*modules[root], root, results, only)
    print(json.dumps({"card": card, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
