#!/usr/bin/env python3
"""Card times of K6 (the adaLN backward) and K1 (the fused sampler step) at the paths' shapes, and of the DiT
training step that runs K6, to A/B two trees.

    python3 scripts/bench_step_kernels.py [--root TREE ...] [--rounds 2] [--only PREFIX,...]

Each ``--root`` is a checkout of the repository (default: this one).  The trees are timed in turns
within one process (root 1, root 2, ..., then the same in reverse order, ``--rounds`` times), each
from its own ``skrample_tpu_torch`` package and its own kernel build, so that two versions are
compared on one card.  ``--only`` keeps the cases whose labels start with one of the prefixes
("K6", "K1", "DiT").  For every kernel case: the kernel's card time (CUDA-graph replay of many calls,
L2-warm), its bytes bound (each input read once, each output written once, over 3.35 TB/s), the
plain version's card time, and the wrapper's host time per launch (the median over 200 eager calls,
host clock, no synchronize); K6's time is also split by kernel from a torch.profiler trace, each
instant of the card's busy time counted once (``chip_smoke.card_time``: a programmatic dependent
launch is traced from its launch, while the kernel before it still runs).  Each kernel is first held
to its plain version (K1 bit for bit; K6 dx within 1e-4 (f32) or 2**-7 (bf16) of its largest value,
the sums within 1e-4).  No library call computes either function.  "DiT train step" is
``chip_smoke.py`` phase 4's step (DiT-512/8 bf16, batch 4 of 4x64x64, flash attention, AdamW, EMA):
the median wall time of 20 steps, and over 3 traced steps the card's busy time (the union of the
kernels' spans) beside the plain sum of the spans, and K6's share.  Prints one line a measurement
and, last, a JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from bench_conv_kernels import HBM_BYTES_PER_S, card_time, graph_ms, host_us, load_tree, split_ms  # noqa: E402

# (label, (B, N, D), dtype): the DiT training slice's adaLN backward, and a ragged N (a short last chunk)
K6_CASES = (
    ("K6 bf16", (4, 1024, 512), "bfloat16"),
    ("K6 f32", (4, 1024, 512), "float32"),
    ("K6 bf16 ragged", (2, 250, 768), "bfloat16"),
)
K6_GROUPS = (("main", "adaln_bwd_kernel"), ("reduce", "adaln_bwd_reduce_kernel"))
# (label, latent shape, dtype, rows, K): the DiT slice, a synthesized-store step, bf16, the video and SDXL
# latents, and one 8-element latent: the least a launch costs
K1_CASES = (
    ("K1 f32 rows 1 K 4", (4, 4, 64, 64), "float32", 1, 4),
    ("K1 f32 rows 3 K 7", (4, 4, 64, 64), "float32", 3, 7),
    ("K1 bf16 rows 1 K 4", (4, 4, 64, 64), "bfloat16", 1, 4),
    ("K1 f32 video rows 1 K 4", (16, 4, 64, 64), "float32", 1, 4),
    ("K1 f32 sdxl rows 1 K 4", (1, 4, 128, 128), "float32", 1, 4),
    ("K1 floor n 8", (8,), "float32", 1, 4),
)


def _record(results: dict, label: str, key: str, ms: float, host: float, extra: dict) -> dict:
    row = results.setdefault(label, extra)
    row.setdefault(key, []).append(ms)
    row.setdefault(f"{key} host_us", []).append(host)
    return row


def measure_k6(adaln, root: Path, results: dict, only: tuple[str, ...]) -> None:
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(21)
    for label, shape, dtype_name in K6_CASES:
        if not label.startswith(only):
            continue
        dtype = getattr(torch, dtype_name)
        B, N, D = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        scale = torch.randn((B, 6 * D), generator=gen, device=dev).to(dtype)[:, 2 * D : 3 * D]
        args = (x, g, scale)
        got = adaln.adaln_backward(*args)
        want = adaln.adaln_backward_reference(*args)
        torch.cuda.synchronize()
        for i, (mine, ref) in enumerate(zip(got, want)):
            rel = (1e-4 if dtype == torch.float32 else 2**-7) if i == 0 else 1e-4
            err = (mine.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
            if err > rel:
                raise SystemExit(f"{label} at {root}: output {i} off its plain version by {err} (relative)")
        n_bytes = 3 * x.numel() * x.element_size() + B * D * x.element_size() + 2 * B * D * 4
        bound = n_bytes / HBM_BYTES_PER_S * 1e3

        def kernel(a=args):
            return adaln.adaln_backward(*a)

        ms = graph_ms(kernel, 50)
        row = _record(results, label, str(root), ms, host_us(kernel), {"shape": list(shape), "bound_ms": bound})
        split = split_ms(kernel, K6_GROUPS)
        row.setdefault(f"{root} split", []).append(split)
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(lambda a=args: adaln.adaln_backward_reference(*a), 10)
        parts = ", ".join(f"{name} {t * 1e3:.2f}" for name, t in sorted(split.items()))
        print(f"{label} {shape} [{root}]: {ms * 1e3:.2f} us (traced: {parts}), host {row[f'{root} host_us'][-1]:.1f} "
              f"us/launch; bound {bound * 1e3:.2f} us (bytes), plain {row['plain_ms'] * 1e3:.2f} us")


def measure_k1(fused, root: Path, results: dict, only: tuple[str, ...]) -> None:
    import numpy as np
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(22)
    for label, shape, dtype_name, rows, K in K1_CASES:
        if not label.startswith(only):
            continue
        dtype = getattr(torch, dtype_name)
        w = np.random.default_rng(K).standard_normal((rows, K))
        basis = [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(K)]
        n_bytes = (K + rows) * basis[0].numel() * basis[0].element_size()
        bound = n_bytes / HBM_BYTES_PER_S * 1e3

        def kernel(w=w, basis=basis):
            return fused.fused_step_cuda(w, basis)

        if not torch.equal(kernel(), fused.fused_step(w, basis)):
            raise SystemExit(f"{label} at {root}: not bit-exact against the plain chain")
        ms = graph_ms(kernel, 200)
        row = _record(results, label, str(root), ms, host_us(kernel), {"shape": list(shape), "bound_ms": bound})
        if "plain_ms" not in row:
            row["plain_ms"] = graph_ms(lambda w=w, basis=basis: fused.fused_step(w, basis), 50)
        print(f"{label} {shape} [{root}]: {ms * 1e3:.2f} us, host {row[f'{root} host_us'][-1]:.1f} us/launch; "
              f"bound {bound * 1e3:.2f} us (bytes), plain {row['plain_ms'] * 1e3:.2f} us")


STEP_MODULES = ("training", "models.dit", "models.ema")


def measure_step(root: Path, results: dict, only: tuple[str, ...]) -> None:
    """``chip_smoke.py`` phase 4's training step from the tree at ``root``: 3 warm-up steps, the median wall
    time of 20, then 3 traced steps."""
    import statistics
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    label = "DiT train step"
    if not label.startswith(only):
        return
    training, dit, ema_mod = load_tree(root, STEP_MODULES)  # this tree's modules in sys.modules while it runs
    dev = torch.device("cuda")
    config = dit.DiTConfig(
        dim=512, depth=8, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash"
    )
    model = dit.DiT(config, device=dev).load_jax_params(dit.random_param_tree(config, seed=0))
    opt = training.make_optimizer(model)
    ema = ema_mod.ema_init(model)
    data = training.synthetic_dataset(64, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [training.draw_batch(data, 4, gen) for _ in range(23)]
    for step in range(3):
        training.train_step(model, opt, ema, *batches[step], step=step)
    torch.cuda.synchronize()
    times = []
    for step in range(3, 23):
        t0 = time.perf_counter()
        training.train_step(model, opt, ema, *batches[step], step=step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    traced = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(traced):
            training.train_step(model, opt, ema, *batches[i], step=23 + i)
        torch.cuda.synchronize()
    kernel_ms, _launches, busy = card_time(prof)
    spans = sum(
        e.time_range.end - e.time_range.start
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    )
    k6 = sum(ms for name, ms in kernel_ms.items() if "adaln_bwd" in name)
    numbers = {
        "wall_ms": statistics.median(times) * 1e3,
        "busy_ms": busy / traced,
        "span_sum_ms": spans / 1e3 / traced,
        "k6_ms": k6 / traced,
    }
    row = results.setdefault(label, {})
    for key, value in numbers.items():
        row.setdefault(f"{root} {key}", []).append(value)
    print(f"{label} [{root}]: wall median {numbers['wall_ms']:.2f} ms; card busy {numbers['busy_ms']:.3f} ms a step "
          f"(union of spans; sum of spans {numbers['span_sum_ms']:.3f}), K6 {numbers['k6_ms'] * 1e3:.1f} us a step")
    del model, opt, ema, data, batches
    torch.cuda.empty_cache()


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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    roots = [r.resolve() for r in (args.root or [Path(__file__).resolve().parent.parent])]
    modules = {root: load_tree(root, ("ops.adaln", "ops.fused")) for root in roots}
    results: dict = {}
    for _ in range(args.rounds):
        for root in roots + roots[::-1]:
            adaln, fused = modules[root]
            measure_k6(adaln, root, results, only)
            measure_k1(fused, root, results, only)
            measure_step(root, results, only)
    print(json.dumps({"card": card, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
