#!/usr/bin/env python
"""Where one serving dispatch's time goes, for the PyTorch/CUDA port on one GPU.

    python scripts/profile_torch_slice.py [--batch 4] [--depth 8] [--steps 25] [--int8]

Drives the serving slice that ``chip_smoke.py`` drives (ServingEngine over a
DiT-512, heads 4, bf16, random weights from a numpy seed; 25-step DPM++2M over
FlowShift(Linear); 4x64x64 latents; with ``--int8`` the DiT's int8 serving
model, ``DiT.quantize_params()``), then:

* times ``--reps`` dispatches of ``--batch`` requests on the host clock,
  each ending in a synchronize (the latency a caller sees);
* traces one dispatch with ``torch.profiler`` and sums the card's kernel
  time by group: the port's three kernels, matrix products (cuBLAS), and
  the rest (elementwise, reductions, copies), with the largest of those by
  name; the card's idle share is one minus its busy time over the median
  untraced dispatch (tracing slows the host, not the kernels);
* counts kernel launches per denoise step, the overhead eager PyTorch pays
  on the host for each.

Prints one JSON line last.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile

from skrample_tpu_torch import scheduling
from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
from skrample_tpu_torch.sampling import models, structured
from skrample_tpu_torch.serving import ServingEngine

GROUPS = (
    ("K1 fused_step", ("fused_step_kernel",)),
    ("K2 flash_qkv", ("flash_qkv_sm90_kernel",)),
    ("K3 adaln", ("adaln_kernel",)),
    ("B6 quant_rows", ("quant_rows_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
)


def group_of(name: str) -> str:
    lowered = name.lower()
    for label, needles in GROUPS:
        if any(n in lowered for n in needles):
            return label
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--depth", type=int, default=8)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0, help="weight seed")
    parser.add_argument("--int8", action="store_true", help="serve the int8 model (kernel B6 in front of each block product)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    config = DiTConfig(dim=512, depth=args.depth, heads=4, compute_dtype=torch.bfloat16, attention="flash")
    model = DiT(config, device="cuda").load_jax_params(random_param_tree(config, args.seed))
    model.requires_grad_(False)
    if args.int8:
        model = model.quantize_params()
    engine = ServingEngine(
        model.as_sampleable(), (4, 64, 64), sampler=structured.DPM(order=2),
        schedule=scheduling.FlowShift(scheduling.Linear()), model_transform=models.FlowModel(),
        steps=args.steps, buckets=(args.batch,), max_delay_ms=50.0, device="cuda",
    )

    def dispatch(base: int) -> float:
        t0 = time.perf_counter()
        futures = [engine.submit(base + i) for i in range(args.batch)]
        for f in futures:
            f.result()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with engine:
        for i in range(2):
            dispatch(1000 * (i + 1))
        walls = [dispatch(10_000 + 100 * i) for i in range(args.reps)]

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            traced_wall = dispatch(99_000)

    device_us: dict[str, float] = {}
    launches: dict[str, int] = {}
    others: dict[str, float] = {}
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", 0.0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and dev > 0:
            label = group_of(evt.key)
            device_us[label] = device_us.get(label, 0.0) + dev
            launches[label] = launches.get(label, 0) + evt.count
            if label == "other":
                others[evt.key[:80]] = others.get(evt.key[:80], 0.0) + dev
    busy_ms = sum(device_us.values()) / 1e3
    median_ms = statistics.median(walls) * 1e3
    result = {
        "card": card,
        "batch": args.batch,
        "steps": args.steps,
        "depth": args.depth,
        "int8": args.int8,
        "dispatch_ms_median": median_ms,
        "dispatch_ms_all": [w * 1e3 for w in walls],
        "img_per_s": args.batch / statistics.median(walls),
        "traced_dispatch_ms": traced_wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / median_ms,
        "device_ms_by_group": {k: v / 1e3 for k, v in sorted(device_us.items())},
        "kernel_launches_by_group": launches,
        "launches_per_step": sum(launches.values()) / args.steps,
        "largest_other_kernels_ms": {k: v / 1e3 for k, v in sorted(others.items(), key=lambda kv: -kv[1])[:8]},
    }
    for label in sorted(device_us, key=device_us.get, reverse=True):
        print(f"{label:>14}: {device_us[label] / 1e3:8.3f} ms on the card, {launches[label]} launches")
    print(f"dispatch {median_ms:.2f} ms median of {args.reps}; card busy {busy_ms:.2f} ms "
          f"(idle {100 * result['device_idle_share']:.1f}%); "
          f"{result['launches_per_step']:.0f} launches per step ({card})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
