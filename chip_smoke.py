#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA device, nvcc

Phases, each failing the run with a non-zero exit:

1. device: the card's name, count, power limit; build the hand-written
   kernels from ``skrample_tpu_torch/csrc`` (printing ``-Xptxas -v``);
2. kernels: each kernel against its plain PyTorch version on the card at the
   serving slice's shapes, with CUDA-event times of the kernel, the plain
   version and, where one PyTorch call computes the same function, that call;
3. the slice: a ``ServingEngine`` over a DiT-512/8 (heads 4, bf16, random
   weights from a numpy seed), 25-step DPM++2M / FlowShift(Linear), buckets
   (1, 2, 4), answering 6 requests (4 together, then 2); the launch counters
   must show every kernel on that path; outputs must be finite, invariant to
   packing, and agree with the same request run through the plain versions;
   then request latency and images per second.

The second-to-last line is a JSON object listing the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
``skrample_tpu_torch`` package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

STEPS = 25
DEPTH = 8
SEEDS = (11, 12, 13, 14, 15, 16)


class SmokeFailure(RuntimeError):
    pass


def expect(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def _events_ms(run, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int = 50) -> tuple[float, float]:
    """Time of one call on the card, L2-warm: ``(device_ms, eager_ms)``.

    ``device_ms`` replays ``iters`` calls captured in one CUDA graph, so the
    host's launch overhead drops out and the number is the card's own time;
    ``eager_ms`` is CUDA events around ``iters`` eager calls, which for a
    kernel shorter than its Python wrapper measures the host."""
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
    device_ms = _events_ms(graph.replay, iters)

    def eager():
        for _ in range(iters):
            fn()

    eager()
    torch.cuda.synchronize()
    return device_ms, _events_ms(eager, iters)


def timed(row: dict, key: str, fn) -> None:
    "Store the card's time under ``key`` and the eager per-call time beside it."
    row[key], row[key + "_eager"] = cuda_ms(fn)


def bound_ms(n_bytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    "The least time the card could take: the larger of the bytes and the operations bound."
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def device_phase() -> dict:
    import torch

    from skrample_tpu_torch.ops import _cuda

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} (count {count})")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s from {_cuda.CSRC}")
    print("---- nvcc -Xptxas -v ----")
    print(_cuda.build_log().strip())
    print("---- end of build log ----")
    return {"name": name, "count": count, "card": card}


def kernels_phase() -> dict[str, dict]:
    "Each kernel against its plain version at the slice's shapes; times and bounds."
    import numpy as np
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.ops import adaln, compile_sampler, flash_attention, fused
    from skrample_tpu_torch.sampling import models, structured

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1234)
    rows: dict[str, dict] = {}

    # ---- K1: fused step.  Weights: DPM++2M / FlowShift(Linear) at step 10 ----
    compiled = compile_sampler(
        structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), STEPS
    )
    w_slice = compiled.weights[10, :1, :4]  # rows 1 over (x, o, hs1, hp1)
    cases = [
        ("slice f32 rows 1 K 4", torch.float32, w_slice, 1e-6),
        ("f32 rows 3 K 7", torch.float32, np.random.default_rng(0).standard_normal((3, 7)), 1e-6),
        ("bf16 rows 1 K 4", torch.bfloat16, w_slice, 1e-2),
    ]
    for label, dtype, w, rel in cases:
        basis = [torch.randn((4, 4, 64, 64), generator=gen, device=dev).to(dtype) for _ in range(w.shape[1])]
        got = fused.fused_step_cuda(w, basis)
        ref = fused.fused_step(w, basis)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = rel * ref.float().abs().max().item()
        print(f"K1 fused_step_cuda {label}: max_abs_err {err:.3e} (tolerance {tol:.3e}; 0 means bit-exact)")
        ok = bool(torch.isfinite(got).all()) and err <= tol
        expect(ok, f"K1 {label} disagrees with the plain chain: {err} > {tol}")
        if label.startswith("slice"):
            n_bytes = (len(basis) + w.shape[0]) * basis[0].numel() * basis[0].element_size()
            flops = 2 * len(basis) * w.shape[0] * basis[0].numel()
            b_ms, b_by = bound_ms(n_bytes, flops, PEAK_F32_FLOPS)
            rows["fused_step_cuda"] = {
                "name": "fused_step_cuda",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/fused_step.cu",
                "replaces": "skrample_tpu/ops/fused.py:59",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
            }
            timed(rows["fused_step_cuda"], "ms", lambda w=w, basis=basis: fused.fused_step_cuda(w, basis))
            timed(rows["fused_step_cuda"], "plain_ms", lambda w=w, basis=basis: fused.fused_step(w, basis))

    # ---- K2: fused-qkv attention, bf16 B 4 H 4 N 1024 d 128 ----
    B, N, H, d = 4, 1024, 4, 128
    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    got = flash_attention.flash_attention_qkv_forward(qkv, H)
    ref = flash_attention._qkv_reference(qkv, H)
    q, k, v = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)

    def library_attention():
        return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, N, H * d)

    torch.cuda.synchronize()
    err = max_err(got, ref)
    tol = 5e-3
    print(
        f"K2 flash_attention_qkv_forward bf16 {tuple(qkv.shape)}: max_abs_err {err:.3e} (tolerance {tol:.1e}; "
        f"max |ref| {ref.float().abs().max().item():.3e}); SDPA vs plain {max_err(library_attention(), ref):.3e}"
    )
    expect(bool(torch.isfinite(got).all()) and err <= tol, f"K2 disagrees with the plain attention: {err} > {tol}")
    b_ms, b_by = bound_ms((qkv.numel() + got.numel()) * 2, 4 * B * H * N * N * d, PEAK_BF16_FLOPS)
    rows["flash_attention_qkv_forward"] = {
        "name": "flash_attention_qkv_forward",
        "route": "cuda",
        "source": "skrample_tpu_torch/csrc/flash_attention.cu",
        "replaces": "skrample_tpu/ops/flash_attention.py:311",
        "max_abs_err": err,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    timed(rows["flash_attention_qkv_forward"], "ms", lambda: flash_attention.flash_attention_qkv_forward(qkv, H))
    timed(rows["flash_attention_qkv_forward"], "plain_ms", lambda: flash_attention._qkv_reference(qkv, H))
    timed(rows["flash_attention_qkv_forward"], "library_ms", library_attention)

    # ---- K3: adaLN, bf16 (4, 1024, 512), shift/scale as column chunks of the modulation matrix ----
    D = 512
    for dtype, rel in ((torch.bfloat16, 2**-7), (torch.float32, 1e-5)):
        x = (torch.randn((4, N, D), generator=gen, device=dev) * 2 + 0.5).to(dtype)
        mods = torch.randn((4, 6 * D), generator=gen, device=dev).to(dtype)
        shift, _gate, scale = mods[:, :D], mods[:, D : 2 * D], mods[:, 2 * D : 3 * D]
        got = adaln.adaln_forward(x, shift, scale)
        ref = adaln.adaln_reference(x, shift, scale)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = rel * ref.float().abs().max().item()
        print(f"K3 adaln_forward {dtype} {tuple(x.shape)}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
        ok = bool(torch.isfinite(got).all()) and err <= tol
        expect(ok, f"K3 {dtype} disagrees with the plain adaLN: {err} > {tol}")
        if dtype == torch.bfloat16:
            b_ms, b_by = bound_ms((2 * x.numel() + 2 * 4 * D) * 2, 10 * x.numel(), PEAK_F32_FLOPS)
            rows["adaln_forward"] = {
                "name": "adaln_forward",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/adaln.cu",
                "replaces": "skrample_tpu/ops/adaln.py:61",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
            }
            args = (x, shift, scale)
            timed(rows["adaln_forward"], "ms", lambda args=args: adaln.adaln_forward(*args))
            timed(rows["adaln_forward"], "plain_ms", lambda args=args: adaln.adaln_reference(*args))
    for row in rows.values():
        library = "n/a" if row["library_ms"] is None else f"{row['library_ms'] * 1e3:.2f} us"
        print(
            f"{row['name']} (card time, CUDA-graph replay): {row['ms'] * 1e3:.2f} us kernel, "
            f"{row['plain_ms'] * 1e3:.2f} us plain, library {library}, "
            f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}); eager per call: "
            f"{row['ms_eager'] * 1e3:.2f} us kernel, {row['plain_ms_eager'] * 1e3:.2f} us plain"
        )
    return rows


def _counters() -> dict[str, int]:
    from skrample_tpu_torch.ops import adaln, flash_attention, fused

    return {
        "fused_step_cuda": fused.fused_step_cuda.launches,
        "flash_attention_qkv_forward": flash_attention.flash_attention_qkv_forward.launches,
        "adaln_forward": adaln.adaln_forward.launches,
    }


def _reset_counters() -> None:
    from skrample_tpu_torch.ops import adaln, flash_attention, fused

    fused.fused_step_cuda.launches = 0
    flash_attention.flash_attention_qkv_forward.launches = 0
    adaln.adaln_forward.launches = 0


def _relative(a, b) -> float:
    return max_err(a, b) / max(b.float().abs().max().item(), 1e-12)


def slice_phase(card: str) -> dict[str, int]:
    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.ops import adaln, flash_attention, fused
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    config = DiTConfig(
        dim=512, depth=DEPTH, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash"
    )
    model = DiT(config, device="cuda").load_jax_params(random_param_tree(config, seed=0))
    model.requires_grad_(False)
    per_dispatch = {
        "fused_step_cuda": STEPS,
        "flash_attention_qkv_forward": DEPTH * STEPS,
        "adaln_forward": (2 * DEPTH + 1) * STEPS,
    }
    item_shape = (4, 64, 64)

    engine = ServingEngine(
        model.as_sampleable(),
        item_shape=item_shape,
        sampler=structured.DPM(order=2),
        schedule=scheduling.FlowShift(scheduling.Linear()),
        model_transform=models.FlowModel(),
        steps=STEPS,
        dtype=torch.float32,
        buckets=(1, 2, 4),
        max_delay_ms=50.0,
        device="cuda",
    )
    with engine:
        engine.generate(99).cpu()  # warm-up: library handles, allocator

        # ---- the main path: 6 requests, 4 together then 2 ----
        batches_before = engine.stats.batches
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        first = [engine.submit(s) for s in SEEDS[:4]]
        outs = [f.result() for f in first]
        second = [engine.submit(s) for s in SEEDS[4:]]
        outs += [f.result() for f in second]
        outs = [o.cpu() for o in outs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counters()
        dispatches = engine.stats.batches - batches_before
        buckets = engine.stats.bucket_counts
        print(f"slice: 6 requests in {dispatches} dispatches, {wall * 1e3:.1f} ms; buckets {buckets}")
        print(f"slice: launches {launches} (per dispatch expected {per_dispatch})")
        expect(dispatches == 2, f"expected 2 dispatches (4 + 2), got {dispatches}")
        for name, count in launches.items():
            want = per_dispatch[name] * dispatches
            expect(count == want, f"{name} launched {count} times, expected {want}")
        for o in outs:
            expect(tuple(o.shape) == item_shape and o.dtype == torch.float32, f"bad output {tuple(o.shape)} {o.dtype}")
            expect(bool(torch.isfinite(o).all()), "non-finite output latent")

        # ---- packing invariance: request 0 alone (bucket 1) vs in the batch of 4 ----
        solo = engine.generate(SEEDS[0]).cpu()
        packing = _relative(solo, outs[0])
        print(f"slice: packing invariance, request 0 solo vs packed: relative max err {packing:.3e} (tol 5e-2, bf16)")
        expect(packing <= 5e-2, f"packing changes request 0 by {packing}")

        # ---- the same request through the plain versions ----
        _reset_counters()
        plain_fused = lambda w, basis: fused.fused_step(w, basis)  # noqa: E731
        with (
            mock.patch("skrample_tpu_torch.ops.loop.fused_step_cuda", plain_fused),
            mock.patch.object(flash_attention, "flash_attention_qkv_forward", flash_attention._qkv_reference),
            mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
        ):
            plain = engine.generate(SEEDS[0]).cpu()
        expect(all(v == 0 for v in _counters().values()), f"the plain run launched kernels: {_counters()}")
        vs_plain = _relative(solo, plain)
        print(f"slice: kernels vs plain versions, request 0: relative max err {vs_plain:.3e} (tolerance 5e-2, bf16)")
        ok = bool(torch.isfinite(plain).all()) and vs_plain <= 5e-2
        expect(ok, f"kernel path differs from plain path by {vs_plain}")

        # ---- latency and throughput, at the engine's default 2 ms batching window ----
        engine.max_delay_s = 2e-3
        solo_s, batch_s = [], []
        for i in range(3):
            t0 = time.perf_counter()
            engine.generate(200 + i).cpu()
            solo_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            futs = [engine.submit(300 + 4 * i + j) for j in range(4)]
            for f in futs:
                f.result().cpu()
            batch_s.append(time.perf_counter() - t0)
        print(f"slice: request latency, bucket 1: {min(solo_s) * 1e3:.2f} ms (min of 3; {card})")
        best = min(batch_s)
        print(f"slice: batch of 4 latency: {best * 1e3:.2f} ms, {4 / best:.2f} img/s (min of 3; {card})")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "skrample_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the skrample_tpu_torch package is not beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    try:
        device = device_phase()
        rows = kernels_phase()
        launches = slice_phase(device["card"])
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1

    for name, count in launches.items():
        rows[name]["launches"] = count
    keys = (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
    )
    print(device["card"])  # name and power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["name"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
