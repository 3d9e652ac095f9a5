#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA device, nvcc

Phases, each failing the run with a non-zero exit:

1. device: the card's name, count, power limit; build the hand-written
   kernels from ``skrample_tpu_torch/csrc`` (printing ``-Xptxas -v``);
2. kernels: each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (K1-K3 serving, K4-K6 training, B6/B7 Flux and
   int8 serving, B8/B10 SDXL serving, B12 at four f32 shapes of the SDXL
   VAE's fused decode, bf16 with the norm, at the video decode's finest
   level with the norm and bare at its 3-channel out_conv, and bare at the
   SDXL UNet's 320-, 640- and 1280-channel convs), with card times of the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call, and B12's and B13's host time a launch and plan;
3. the serving slice: a ``ServingEngine`` over a DiT-512/8 (heads 4, bf16,
   random weights from a numpy seed), 25-step DPM++2M / FlowShift(Linear),
   buckets (1, 2, 4), answering 6 requests (4 together, then 2); the launch
   counters must show every kernel on that path; outputs must be finite,
   invariant to packing, and agree with the same request run through the
   plain versions; then request latency and images per second;
4. the training slice: the same DiT trained by ``training.train_step``
   (flow matching, AdamW, EMA) on batches of 4 latents of 4x64x64, 3 warm-up
   steps and 20 timed ones; exact launch counts per step; finite loss and
   grads, parameters and EMA moved; one step's loss and every gradient
   against the same step through the plain versions; an ``.npz`` round trip
   of the trained parameters; the median step time, the peak memory, and
   the card's time by kernel group over 3 traced steps (which must show
   both K5 kernels once per block and step);
5. int8 DiT serving: the phase-3 DiT with its block weights quantized
   (``DiT.quantize_params``) serves the same 6 requests; B6 launches once
   per int8 product (32 per denoise step); each output within cosine 0.99
   of the bf16 output of the same request; latency and throughput;
6. Flux serving at FLUX.1-dev's published widths and depth (19 double + 38
   single blocks, dim 3072, 24 heads of 128, T5 4096, CLIP 768), bf16
   weights drawn on the card, 1024x1024 requests (4096 image + 512 text
   tokens) with random prompt features, guidance 3.5, 28-step DPM++2M /
   FlowShift(Linear), buckets (1, 2): 3 requests (2 together, then the
   first again alone); exact launches per forward (K2 57, K3 115, B7 76),
   finite and packing-invariant outputs, one forward through the kernels
   against the plain versions; then the int8 model (``quantize_params``)
   serves 2 requests with B6 at 266 launches per forward, each within
   cosine 0.99 of the bf16 output of the same request; per configuration
   the median request latency (bucket 1), images per second (bucket 2),
   peak memory and the card's busy share over one traced dispatch;
7. SDXL base serving: the published conditional UNet (widths (320, 640,
   1280), transformer depths (0, 2, 10), heads of 64, context 2048, pooled
   1280; 2.57B parameters in bf16 drawn on the card) behind
   ``SDXLStack.as_served`` with classifier-free guidance 5.0, 25-step
   DPM++2M over Karras(Scaled) with NoiseModel, buckets (1, 2), 1024x1024
   requests (4x128x128 latents) with random prompt features: 3 requests
   (2 together, then the first again alone); exact launches (B8 46, B10 70
   and B12 38 per forward, K1 one per step), finite outputs, request A
   alone equal to A packed bit for bit, one CFG forward through the
   kernels against the plain versions, the compiled Karras(Scaled)
   trajectory on the card against the CPU's, the port's bf16 conv against
   one rounding of the f32 sum (ROADMAP C7; cuDNN's double rounding
   beside it), every cuDNN conv's operands channels-last; latency,
   throughput, peak memory and the card's time by kernel group over one
   traced dispatch;
8. SDXL to pixels: the SDXL base VAE (stabilityai/stable-diffusion-xl-
   base-1.0 ``vae/config.json`` through the port's ``vae_config``: f32,
   83.7M parameters drawn on the card) behind the phase-7 UNet,
   ``ServingEngine(stack.as_served(...), conditioned=True,
   postprocess=stack.decode)``, 10-step requests (phase 7's 25 cut: the
   phase adds the decode): 3 requests to (3, 1024, 1024) pixels (2
   together, then the first alone); exact launches (B12 31 and B8 1 per
   decode on top of the UNet's), finite pixels, A alone == A packed bit
   for bit, the fused decode against the unfused one and against the
   plain versions (1e-3 relative Frobenius), median fused and unfused
   decode times, one traced fused decode by kernel group, and one
   ``encode_image`` at 1024x1024;
9. DiT-384/6 (heads of 64: B9a 6 a forward) served, and (9b) the SDXL UNet
   read at head dim 32 (B9b);
10. the video family to pixels: VideoDiT-512/8 and the VideoVAE (B12, B13);
11. sequence-parallel serving on a one-rank NCCL group
    (``make_mesh(dp=1, sp=1)``): the phase-3 DiT with ``attention="ring"``
    (B11 once a block) and the phase-9 DiT with ``attention="ulysses"``
    (B9a once a block) through ``ServingEngine``: exact launches, A alone ==
    A packed bit for bit, each request against its flash DiT's, one forward
    against the plain versions, latency medians and one traced request.
    Phase 2 holds B11 to its plain version at four ring-hop shapes.

Every read of the launch counters holds each K2, K4, K5, B9, B10 and B11
launch to the route of the Hopper kernels (wgmma: ``csrc/flash_attention_sm90.cu``
and ``csrc/flash_attention_bwd.cu``), and each path phase prints its attention
launches by route; the device phase requires the sixteen Hopper attention
instantiations to build without spills or injected warpgroup fences.

The second-to-last line is a JSON object listing the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
``skrample_tpu_torch`` package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
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
TRAIN_WARMUP = 3
TRAIN_STEPS = 20
FLUX_STEPS = 28  # FLUX.1-dev's default
FLUX_REPEATS = 3  # dispatches per median
SDXL_STEPS = 25
SDXL_REPEATS = 3
VAE_STEPS = 10  # phase 8 cuts phase 7's 25-step schedule: the decode, not the denoise, is what it adds


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


def timed(row: dict, key: str, fn, iters: int = 50) -> None:
    "Store the card's time under ``key`` and the eager per-call time beside it."
    row[key], row[key + "_eager"] = cuda_ms(fn, iters)


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
    stats = _sm90_instantiations(_cuda.build_log())
    for label, st in stats.items():
        print(
            f"{label}: {st.get('registers')} registers at launch, {st.get('spills')} bytes spilled, "
            f"{st['fences']} warpgroup fences or serialisations injected by ptxas"
        )
    attention = {label: st for label, st in stats.items() if label.startswith("flash_")}
    expect(len(attention) == 16, f"expected 16 Hopper attention instantiations in the build log: {sorted(attention)}")
    for label, st in attention.items():
        expect(st.get("spills") == 0 and st["fences"] == 0, f"{label}: {st.get('spills')} bytes spilled, {st['fences']} fences")
    return {"name": name, "count": count, "card": card}


def _sm90_label(mangled: str) -> str | None:
    """A Hopper instantiation's readable name from its mangled one: the convs' <WN, MT> (a consumer
    warpgroup's N width and M tiles), the attention's <type, head dim, lse> (the forward body's K2/K4, B9/B10
    and B11 kernels, K5's dq and dkv kernels); None for other kernels."""
    import re

    conv = re.search(r"(conv3x3|tconv)_sm90_kernelILi(\d+)ELi(\d+)E", mangled)
    if conv:
        return f"{conv.group(1)}_sm90_kernel<{conv.group(2)}, {conv.group(3)}>"
    kernels = "flash_qkv|flash_strided|flash_block_stats|flash_bwd_dq|flash_bwd_dkv"
    attention = re.search(rf"({kernels})_sm90_kernelI(\w*?)EEv", mangled)
    if attention:
        args = attention.group(2) + "E"
        parts = ["bf16" if "bfloat16" in args else "f16", *(f"d {v}" for v in re.findall(r"Li(\d+)E", args))]
        if "Lb1E" in args:
            parts.append("lse")
        return f"{attention.group(1)}_sm90_kernel<{', '.join(parts)}>"
    return None


def _sm90_instantiations(log: str) -> dict[str, dict]:
    """B12's, B13's and the attention's Hopper instantiations with their registers at launch (setmaxnreg
    then moves them to the consumers), spills, and the warpgroup fences or serialisations ptxas injected
    (C7519 and its kin), read from the ``-Xptxas -v`` log."""
    import re

    current = None
    stats: dict[str, dict] = {}
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            current = _sm90_label(entry.group(1))
            if current:
                stats.setdefault(current, {"fences": 0})
            continue
        if "C7519" in line or ("wgmma" in line and "serializ" in line):
            name = re.search(r"'(\w+)'", line)
            key = _sm90_label(name.group(1)) if name else None
            if key:
                stats.setdefault(key, {"fences": 0})["fences"] += 1
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            stats[current]["spills"] = int(spill.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            stats[current]["registers"] = int(used.group(1))
            current = None
    return stats


ATTENTION_SM90 = (  # K2, K4, B9, B10, B11 (csrc/flash_attention_sm90.cu) and K5 (csrc/flash_attention_bwd.cu)
    "flash_attention_qkv_forward",
    "flash_attention_qkv_forward_lse",
    "flash_attention_forward",
    "flash_attention_packed_forward",
    "flash_attention_pairs_forward",
    "flash_attention_block_stats",
    "flash_attention_qkv_backward",
)


def _attention_route(name: str, N: int, d: int, fn) -> None:
    """One attention row's route and plan: a call of ``fn`` must count one launch on the wgmma route of
    wrapper ``name``; prints the plan and the wrapper's host time a launch (median of 200 eager calls)."""
    import torch

    from skrample_tpu_torch.ops import flash_attention

    wrapper = getattr(flash_attention, name)
    before = dict(wrapper.routes)
    fn()
    torch.cuda.synchronize()
    expect(wrapper.routes == {"wgmma": before["wgmma"] + 1}, f"{name}: routes {wrapper.routes} after one call")
    plan = flash_attention.attention_plan(N, d)
    print(
        f"{name} N {N} d {d}: route wgmma (csrc/flash_attention_sm90.cu); plan: {plan.block_q} query rows a "
        f"block, keys in tiles of {plan.block_k} through {plan.stages} stages, {plan.smem} bytes of shared "
        f"memory; host {host_us(fn):.1f} us a launch (median of 200)"
    )


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
        "source": "skrample_tpu_torch/csrc/flash_attention_sm90.cu",
        "replaces": "skrample_tpu/ops/flash_attention.py:311",
        "max_abs_err": err,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    timed(rows["flash_attention_qkv_forward"], "ms", lambda: flash_attention.flash_attention_qkv_forward(qkv, H))
    timed(rows["flash_attention_qkv_forward"], "plain_ms", lambda: flash_attention._qkv_reference(qkv, H))
    timed(rows["flash_attention_qkv_forward"], "library_ms", library_attention)
    _attention_route("flash_attention_qkv_forward", N, d, lambda: flash_attention.flash_attention_qkv_forward(qkv, H))

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

    rows.update(training_kernels(gen))
    rows.update(flux_kernels(gen))
    rows.update(sdxl_kernels(gen))
    rows.update(vae_kernels(gen))
    ragged_kernels(gen)
    rows.update(b9_kernels(gen))
    rows.update(tconv_kernels(gen))
    rows.update(b11_kernels(gen))
    for row in rows.values():
        library = "n/a" if row["library_ms"] is None else f"{row['library_ms'] * 1e3:.2f} us"
        print(
            f"{row['name']} (card time, CUDA-graph replay): {row['ms'] * 1e3:.2f} us kernel, "
            f"{row['plain_ms'] * 1e3:.2f} us plain, library {library}, "
            f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}); eager per call: "
            f"{row['ms_eager'] * 1e3:.2f} us kernel, {row['plain_ms_eager'] * 1e3:.2f} us plain"
        )
    return rows


def training_kernels(gen) -> dict[str, dict]:
    "K4-K6 against their plain versions at the training slice's shapes; times and bounds."
    import torch

    from skrample_tpu_torch.ops import adaln, flash_attention

    dev = torch.device("cuda")
    rows: dict[str, dict] = {}
    B, N, H, d, D = 4, 1024, 4, 128, 512
    aten = torch.ops.aten

    # ---- K4: the logsumexp forward, bf16 qkv (4, 1024, 1536) ----
    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    o, lse = flash_attention.flash_attention_qkv_forward_lse(qkv, H)
    ref_o, ref_lse = flash_attention._qkv_reference_lse(qkv, H)
    q, k, v = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)
    lib_fwd = aten._scaled_dot_product_flash_attention(q, k, v)
    torch.cuda.synchronize()
    err, lse_err = max_err(o, ref_o), max_err(lse, ref_lse)
    same_as_k2 = torch.equal(o, flash_attention.flash_attention_qkv_forward(qkv, H))
    o_tol, lse_tol = 5e-3, 1e-3
    print(
        f"K4 flash_attention_qkv_forward_lse bf16 {tuple(qkv.shape)}: o max_abs_err {err:.3e} (tolerance "
        f"{o_tol:.0e}, as K2), lse max_abs_err {lse_err:.3e} (tolerance {lse_tol:.0e}: f32 statistics in another "
        f"order, hardware exp2); identical to K2's output: {same_as_k2}; "
        f"library lse vs plain {max_err(lib_fwd[1], ref_lse[..., 0]):.3e}"
    )
    ok = bool(torch.isfinite(o).all()) and err <= o_tol and lse_err <= lse_tol
    expect(ok, f"K4 disagrees with the plain attention: o {err} > {o_tol} or lse {lse_err} > {lse_tol}")
    b_ms, b_by = bound_ms((qkv.numel() + o.numel()) * 2 + lse.numel() * 4, 4 * B * H * N * N * d, PEAK_BF16_FLOPS)
    row = rows["flash_attention_qkv_forward_lse"] = {
        "name": "flash_attention_qkv_forward_lse",
        "route": "cuda",
        "source": "skrample_tpu_torch/csrc/flash_attention_sm90.cu",
        "replaces": "skrample_tpu/ops/flash_attention.py:419",
        "max_abs_err": max(err, lse_err),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    timed(row, "ms", lambda: flash_attention.flash_attention_qkv_forward_lse(qkv, H))
    timed(row, "plain_ms", lambda: flash_attention._qkv_reference_lse(qkv, H))
    timed(row, "library_ms", lambda: aten._scaled_dot_product_flash_attention(q, k, v))
    _attention_route("flash_attention_qkv_forward_lse", N, 128, lambda: flash_attention.flash_attention_qkv_forward_lse(qkv, H))

    # ---- K5: the backward, from K4's o and lse and a bf16 output gradient ----
    g = torch.randn((B, N, H * d), generator=gen, device=dev).to(torch.bfloat16)
    got = flash_attention.flash_attention_qkv_backward(qkv, o, lse, g, H)
    ref = flash_attention._qkv_backward_reference(qkv, o, lse, g, H)
    lib_args = (
        g.view(B, N, H, d).transpose(1, 2), q, k, v, lib_fwd[0], lib_fwd[1], *lib_fwd[2:6], 0.0, False, *lib_fwd[6:8]
    )
    lib_grads = aten._scaled_dot_product_flash_attention_backward(*lib_args)
    torch.cuda.synchronize()
    rel_tol = 2e-2
    errs = []
    # dq comes from one kernel, dk and dv from the other: each third is checked on its own
    for label, part, want, lib_part in zip(("dq", "dk", "dv"), got.chunk(3, -1), ref.chunk(3, -1), lib_grads):
        scale = want.float().abs().max().item()
        e = max_err(part, want)
        errs.append(e)
        lib_e = max_err(lib_part.transpose(1, 2).reshape(B, N, H * d), want)
        print(
            f"K5 flash_attention_qkv_backward {label}: max_abs_err {e:.3e} (tolerance {rel_tol:.0e} x max|ref| "
            f"{scale:.3e}: 16-bit outputs, P and dS round to bf16 from f32 sums in another order); library vs plain "
            f"{lib_e:.3e}"
        )
        ok = bool(torch.isfinite(part).all()) and scale > 0 and e <= rel_tol * scale
        expect(ok, f"K5 {label} disagrees with the plain backward: {e} > {rel_tol} x {scale}")
    # the function's least work is 10 B H N^2 d; the dq/dkv split does 14 (S and dP twice)
    n_bytes = (qkv.numel() + o.numel() + g.numel() + got.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 10 * B * H * N * N * d, PEAK_BF16_FLOPS)
    row = rows["flash_attention_qkv_backward"] = {
        "name": "flash_attention_qkv_backward",
        "route": "cuda",
        "source": "skrample_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "skrample_tpu/ops/flash_attention.py:524",
        "max_abs_err": max(errs),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    timed(row, "ms", lambda: flash_attention.flash_attention_qkv_backward(qkv, o, lse, g, H))
    timed(row, "plain_ms", lambda: flash_attention._qkv_backward_reference(qkv, o, lse, g, H))
    timed(row, "library_ms", lambda: aten._scaled_dot_product_flash_attention_backward(*lib_args))

    # ---- K6: the adaLN backward, (4, 1024, 512), scale a column chunk of the modulation matrix ----
    for dtype, dx_rel in ((torch.bfloat16, 2**-7), (torch.float32, 1e-4)):
        x = (torch.randn((B, N, D), generator=gen, device=dev) * 2 + 0.5).to(dtype)
        gx = torch.randn((B, N, D), generator=gen, device=dev).to(dtype)
        mods = torch.randn((B, 6 * D), generator=gen, device=dev).to(dtype)
        scale = mods[:, 2 * D : 3 * D]
        got = adaln.adaln_backward(x, gx, scale)
        ref = adaln.adaln_backward_reference(x, gx, scale)
        again = adaln.adaln_backward(x, gx, scale)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = []
        for label, mine, want, rel in zip(("dx", "dshift", "dscale"), got, ref, (dx_rel, 1e-4, 1e-4)):
            e = max_err(mine, want)
            tol = rel * want.float().abs().max().item()
            errs.append(e)
            print(f"K6 adaln_backward {dtype} {tuple(x.shape)} {label}: max_abs_err {e:.3e} (tolerance {tol:.3e})")
            expect(bool(torch.isfinite(mine).all()) and e <= tol, f"K6 {dtype} {label} disagrees: {e} > {tol}")
        print(f"K6 adaln_backward {dtype}: a second run gives the same bits: {same}")
        expect(same, "K6 is not deterministic")
        if dtype == torch.bfloat16:
            n_bytes = 3 * x.numel() * 2 + B * D * 2 + 2 * B * D * 4
            b_ms, b_by = bound_ms(n_bytes, 20 * x.numel(), PEAK_F32_FLOPS)
            row = rows["adaln_backward"] = {
                "name": "adaln_backward",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/adaln.cu",
                "replaces": "skrample_tpu/ops/adaln.py:121",
                "max_abs_err": max(errs),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
            }
            args = (x, gx, scale)
            timed(row, "ms", lambda args=args: adaln.adaln_backward(*args))
            timed(row, "plain_ms", lambda args=args: adaln.adaln_backward_reference(*args))
    return rows


def _ulp_map(a, b):
    "Per element, the distance of two bf16 tensors in units in the last place of the larger magnitude."
    import torch

    a32, b32 = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a32.abs(), b32.abs()).clamp_min(2.0**-126))) - 7)
    return (a32 - b32).abs() / ulp


def _ulps_bf16(a, b) -> float:
    "The largest distance between two bf16 tensors, in units in the last place of the larger magnitude."
    return _ulp_map(a, b).max().item()


def flux_kernels(gen) -> dict[str, dict]:
    """B6 and B7 against their plain versions at the Flux and int8 serving paths' shapes, and K2 at
    the Flux shape; times and bounds."""
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch.ops import flash_attention, quant, rope

    dev = torch.device("cuda")
    rows: dict[str, dict] = {}
    H, d, L, N_IMG = 24, 128, 512, 4096

    # ---- B7: qk-norm + RoPE on bf16 qkv, in place as the blocks run it; tables as row views of the joint ones ----
    angles = torch.rand((L + N_IMG, d // 2), generator=gen, device=dev) * 64
    cos, sin = torch.cos(angles), torch.sin(angles)
    gq = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    gk = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    # 4080 = the 85x48 image tokens of a 1360x768 request: N not a multiple of 128 takes the kernel too
    cases = [
        ("image stream", N_IMG, slice(L, None)),
        ("text stream", L, slice(0, L)),
        ("joint", L + N_IMG, slice(None)),
        ("1360x768 image stream", 4080, slice(L, L + 4080)),
    ]
    for label, n, rows_of in cases:
        qkv = (torch.randn((1, n, 3 * H * d), generator=gen, device=dev) * 2).to(torch.bfloat16)
        c, s_ = cos[rows_of], sin[rows_of]
        want = rope.rope_qk_norm_reference(qkv, gq, gk, c, s_, H)
        fresh = rope.rope_qk_norm_forward(qkv, gq, gk, c, s_, H)
        inplace = rope.rope_qk_norm_forward(qkv.clone(), gq, gk, c, s_, H, in_place=True)
        torch.cuda.synchronize()
        ulps = max(_ulps_bf16(fresh, want), _ulps_bf16(inplace, want))
        v_same = torch.equal(fresh[..., 2 * H * d :], qkv[..., 2 * H * d :]) and torch.equal(inplace, fresh)
        err = max(max_err(fresh, want), max_err(inplace, want))
        print(
            f"B7 rope_qk_norm_forward bf16 {tuple(qkv.shape)} ({label}, tables rows {rows_of.start}:): max_abs_err "
            f"{err:.3e}, {ulps:g} bf16 ulp (tolerance 1 ulp); v third bit-equal and in place == fresh: {v_same}"
        )
        expect(bool(torch.isfinite(fresh).all()) and ulps <= 1 and v_same, f"B7 {label} disagrees: {ulps} ulp, v {v_same}")
        before = rope.rope_qk_norm_forward.launches
        with torch.no_grad():
            via = rope.fused_rope_qk_norm(qkv.clone(), gq, gk, c, s_, H)
        launched = rope.rope_qk_norm_forward.launches - before
        expect(launched == 1 and torch.equal(via, inplace), f"B7 {label}: the model's dispatch launched {launched} times")
        qk_bytes = n * 2 * H * d * 2
        b_ms, b_by = bound_ms(2 * qk_bytes + 2 * c.numel() * 4 + 2 * d * 4, 8 * n * 2 * H * d, PEAK_F32_FLOPS)
        args = (qkv, gq, gk, c, s_, H)
        timing = {}
        timed(timing, "ms", lambda args=args: rope.rope_qk_norm_forward(*args, in_place=True))
        timed(timing, "plain_ms", lambda args=args: rope.rope_qk_norm_reference(*args))
        print(
            f"B7 {label} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel in place, "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, bound {b_ms * 1e3:.2f} us ({b_by})"
        )
        if label == "image stream":
            rows["rope_qk_norm_forward"] = {
                "name": "rope_qk_norm_forward",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/rope.cu",
                "replaces": "skrample_tpu/ops/rope.py:94",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
                **timing,
            }

    # ---- K2 at the Flux shape: bf16 qkv (1, 4608, 9216), 24 heads of 128 ----
    N = L + N_IMG
    qkv = torch.randn((1, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    got = flash_attention.flash_attention_qkv_forward(qkv, H)
    ref = flash_attention._qkv_reference(qkv, H)
    q, k, v = qkv.view(1, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    print(f"K2 flash_attention_qkv_forward bf16 {tuple(qkv.shape)} (Flux): max_abs_err {err:.3e} (tolerance 5.0e-03)")
    expect(bool(torch.isfinite(got).all()) and err <= 5e-3, f"K2 at the Flux shape disagrees: {err}")
    b_ms, b_by = bound_ms((qkv.numel() + got.numel()) * 2, 4 * H * N * N * d, PEAK_BF16_FLOPS)
    timing = {}
    timed(timing, "ms", lambda: flash_attention.flash_attention_qkv_forward(qkv, H))
    timed(timing, "plain_ms", lambda: flash_attention._qkv_reference(qkv, H))
    timed(timing, "library_ms", lambda: F.scaled_dot_product_attention(q, k, v))
    _attention_route("flash_attention_qkv_forward", N, d, lambda: flash_attention.flash_attention_qkv_forward(qkv, H))
    print(
        f"K2 Flux shape (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel, "
        f"{timing['plain_ms'] * 1e3:.2f} us plain, library {timing['library_ms'] * 1e3:.2f} us, "
        f"bound {b_ms * 1e3:.2f} us ({b_by})"
    )
    del qkv, got, ref, q, k, v

    # ---- B6: per-row int8 quantization of bf16 activations: Flux's widths and the int8 DiT's ----
    for label, shape in (("Flux qkv/mlp_in input", (4608, 3072)), ("Flux single out input", (4608, 15360)),
                         ("DiT-512 mlp_out input, bucket 1", (1024 * 1, 2048))):
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(torch.bfloat16)
        x[1] = 0
        q, sc = quant.quantize_rows(x)
        want_q, want_s = quant.quantize_activation(x)
        torch.cuda.synchronize()
        same = torch.equal(q, want_q) and torch.equal(sc, want_s)
        err = max(max_err(q, want_q), max_err(sc, want_s))
        print(f"B6 quantize_rows bf16 {shape} ({label}): q and s bit-equal to the plain version: {same}")
        expect(same, f"B6 {shape} differs from the plain version by {err}")
        R, D = shape
        b_ms, b_by = bound_ms(R * D * 2 + R * D + R * 4, 4 * R * D, PEAK_F32_FLOPS)
        timing = {}
        timed(timing, "ms", lambda x=x: quant.quantize_rows(x))
        timed(timing, "plain_ms", lambda x=x: quant.quantize_activation(x))
        print(
            f"B6 {shape} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel, "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, bound {b_ms * 1e3:.2f} us ({b_by})"
        )
        if "quantize_rows" not in rows:  # the row keeps the first shape's numbers
            rows["quantize_rows"] = {
                "name": "quantize_rows",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/quant.cu",
                "replaces": "skrample_tpu/ops/quant.py:72",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
                **timing,
            }
    return rows


def sdxl_kernels(gen) -> dict[str, dict]:
    """B8 and B10 against their plain versions at the SDXL serving path's shapes (batch 4: bucket 2
    under classifier-free guidance); times and bounds."""
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch.ops import flash_attention, groupnorm

    dev = torch.device("cuda")
    rows: dict[str, dict] = {}

    # ---- B8: GroupNorm(32) + f32 affine + SiLU, eps 1e-5, on (B, H*W, C) views of NHWC activations ----
    cases = [
        ((4, 16384, 320), torch.bfloat16, True, True, 1e-5),
        ((4, 4096, 960), torch.bfloat16, True, True, 1e-5),
        ((4, 1024, 2560), torch.bfloat16, True, True, 1e-5),
        ((4, 4096, 640), torch.float32, False, True, 1e-6),  # the UNet family's resnet form: no affine, eps 1e-6
    ]
    for shape, dtype, affine, silu, eps in cases:
        B, N, C = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1.5).to(dtype)
        scale = (1 + 0.1 * torch.randn(C, generator=gen, device=dev)) if affine else None
        bias = 0.1 * torch.randn(C, generator=gen, device=dev) if affine else None
        got = groupnorm.groupnorm_forward(x, 32, silu, eps, scale, bias)
        want = groupnorm.groupnorm_reference(x, 32, silu, eps, scale, bias)
        again = groupnorm.groupnorm_forward(x, 32, silu, eps, scale, bias)
        torch.cuda.synchronize()
        err = max_err(got, want)
        rel = 2**-7 if dtype == torch.bfloat16 else 1e-5
        tol = rel * want.float().abs().max().item()
        form = ("affine" if affine else "no affine") + (" + SiLU" if silu else "")
        print(
            f"B8 groupnorm_forward {dtype} {shape} ({form}, eps {eps:g}): max_abs_err {err:.3e} (tolerance {tol:.3e}: "
            f"one rounding each, f32 statistics merged in another order); a second run gives the same bits: "
            f"{torch.equal(got, again)}"
        )
        expect(bool(torch.isfinite(got).all()) and err <= tol, f"B8 {shape} disagrees with the plain version: {err}")
        expect(torch.equal(got, again), f"B8 {shape} is not deterministic")
        side = int(math.isqrt(N))
        nchw = x.view(B, side, side, C).permute(0, 3, 1, 2)  # the channels-last NCHW tensor the library takes
        w_lib = (scale if affine else torch.ones(C, device=dev)).to(dtype)
        b_lib = (bias if affine else torch.zeros(C, device=dev)).to(dtype)
        n_bytes = 2 * x.numel() * x.element_size() + (2 * C * 4 if affine else 0)
        b_ms, b_by = bound_ms(n_bytes, 12 * x.numel(), PEAK_F32_FLOPS)
        timing: dict = {}
        args = (x, 32, silu, eps, scale, bias)
        timed(timing, "ms", lambda args=args: groupnorm.groupnorm_forward(*args))
        timed(timing, "plain_ms", lambda args=args: groupnorm.groupnorm_reference(*args))
        timed(timing, "library_ms", lambda a=(nchw, w_lib, b_lib, eps): F.group_norm(a[0], 32, a[1], a[2], a[3]))
        print(
            f"B8 {shape} {dtype} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel, "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, library {timing['library_ms'] * 1e3:.2f} us "
            f"(F.group_norm on the channels-last NCHW tensor, no SiLU), bound {b_ms * 1e3:.2f} us ({b_by})"
        )
        if "groupnorm_forward" not in rows:  # the row keeps the first shape's numbers
            rows["groupnorm_forward"] = {
                "name": "groupnorm_forward",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/groupnorm.cu",
                "replaces": "skrample_tpu/ops/groupnorm.py:145",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                **timing,
            }

    # ---- B10: d = 64 attention on the chunk(3) views of a fused qkv product, bf16 ----
    for B, N, H in ((4, 4096, 10), (4, 1024, 20)):
        d = 64
        qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        got = flash_attention.flash_attention_pairs_forward(q, k, v, H)
        want = flash_attention._packed_reference(q, k, v, H)
        qh, kh, vh = (t.reshape(B, N, H, d).transpose(1, 2).contiguous() for t in (q, k, v))
        torch.cuda.synchronize()
        err = max_err(got, want)
        lib_err = max_err(F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2).reshape(B, N, H * d), want)
        print(
            f"B10 flash_attention_pairs_forward bf16 q/k/v {tuple(q.shape)} views of row stride {q.stride(1)} "
            f"({H} heads of 64): max_abs_err {err:.3e} (tolerance 5.0e-03, as K2); SDPA vs plain {lib_err:.3e}"
        )
        expect(bool(torch.isfinite(got).all()) and err <= 5e-3, f"B10 N={N} disagrees with the plain attention: {err}")
        b_ms, b_by = bound_ms((3 * B * N * H * d + got.numel()) * 2, 4 * B * H * N * N * d, PEAK_BF16_FLOPS)
        timing = {}
        timed(timing, "ms", lambda a=(q, k, v, H): flash_attention.flash_attention_pairs_forward(*a))
        timed(timing, "plain_ms", lambda a=(q, k, v, H): flash_attention._packed_reference(*a))
        timed(timing, "library_ms", lambda a=(qh, kh, vh): F.scaled_dot_product_attention(*a))
        _attention_route("flash_attention_pairs_forward", N, d, lambda a=(q, k, v, H): flash_attention.flash_attention_pairs_forward(*a))
        print(
            f"B10 N {N} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel, "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, library {timing['library_ms'] * 1e3:.2f} us "
            f"(scaled_dot_product_attention on contiguous (B, H, N, 64)), bound {b_ms * 1e3:.2f} us ({b_by})"
        )
        if "flash_attention_pairs_forward" not in rows:
            rows["flash_attention_pairs_forward"] = {
                "name": "flash_attention_pairs_forward",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/flash_attention_sm90.cu",
                "replaces": "skrample_tpu/ops/flash_attention.py:798",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                **timing,
            }
        del qkv, q, k, v, qh, kh, vh, got, want
    return rows


def _plain_b12(x, w, b, stats=None, residual=None, scale=None, bias=None, out_stats=True):
    "B12's plain version behind its wrapper's signature (swapped in for the kernel to hold a path to it)."
    from skrample_tpu_torch.ops import fused_conv

    out, raw = fused_conv.conv3x3_ref(x, w, b, stats, residual, scale, bias)
    return out, (raw if out_stats else None)


def vae_kernels(gen) -> dict[str, dict]:
    """B12 against its plain version: f32 with GroupNorm(32) + f32 affine + SiLU on the input read and a
    residual, at four of the SDXL VAE's fused-decode shapes (the CUDA-core route); bf16 with the norm,
    the affine, a residual and the statistics at (1, 256, 256, 512); the video decode's finest level
    (16 frames of 512x512, 64 -> 64: the norm without affine, a residual, the statistics) and its bare
    64 -> 3 out_conv; and bare, statistics off, the SDXL UNet's convs at (2, 64, 64, 640), (2, 128, 128,
    320) and (2, 32, 32, 1280) (the C7 route); every bf16 shape on the wgmma route.  Times, bounds, the
    plan's shared memory, the wrapper's host time per launch; the library time is ``F.conv2d`` with its
    bias on the input normalized beforehand: the conv alone, not the norm, the residual or the
    statistics."""
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    rows: dict[str, dict] = {}
    bf16 = torch.bfloat16
    cases = [  # (shape, Co, dtype, norm, affine, residual, statistics)
        ((1, 128, 128, 512), 512, torch.float32, True, True, True, True),
        ((1, 256, 256, 512), 512, torch.float32, True, True, True, True),
        ((1, 512, 512, 512), 256, torch.float32, True, True, True, True),
        ((1, 1024, 1024, 256), 128, torch.float32, True, True, True, True),
        ((1, 256, 256, 512), 512, bf16, True, True, True, True),
        ((16, 512, 512, 64), 64, bf16, True, False, True, True),
        ((16, 512, 512, 64), 3, bf16, False, False, False, False),
        ((2, 64, 64, 640), 640, bf16, False, False, False, False),
        ((2, 128, 128, 320), 320, bf16, False, False, False, False),
        ((2, 32, 32, 1280), 1280, bf16, False, False, False, False),
    ]
    for shape, co, dtype, norm, affine, residual, with_stats in cases:
        N, H, W, C = shape
        plan = fused_conv.conv3x3_plan(H, W, C, co, dtype)
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        w = (torch.randn((3, 3, C, co), generator=gen, device=dev) / (3 * C**0.5)).to(dtype)
        b = 0.1 * torch.randn(co, generator=gen, device=dev)
        stats = res = scale = bias = None
        if norm:
            stats = fused_conv.finalize_group_stats(fused_conv.channel_stats(x), min(32, C // 4), H * W)
        if affine:
            scale = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
            bias = 0.1 * torch.randn(C, generator=gen, device=dev)
        if residual:
            res = torch.randn((N, H, W, co), generator=gen, device=dev).to(dtype)
        args = (x, w, b, stats, res, scale, bias)
        got, raw = fused_conv.conv3x3_gn_silu_forward(*args, out_stats=with_stats)
        want, want_raw = fused_conv.conv3x3_ref(*args)
        again, _ = fused_conv.conv3x3_gn_silu_forward(*args, out_stats=with_stats)
        torch.cuda.synchronize()
        err = max_err(got, want)
        rel = err / want.float().abs().max().item()
        raw_rel = _relative(raw, want_raw) if with_stats else 0.0
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        form = ", ".join(
            label for label, on in (("GN + SiLU on read", norm), ("affine", affine), ("residual", residual),
                                    ("statistics", with_stats)) if on
        ) or "norm and statistics off"
        print(
            f"B12 conv3x3_gn_silu_forward {dtype} {shape} -> {co} ({form}; route {plan.route}): max_abs_err "
            f"{err:.3e}, relative {rel:.3e} (tolerance {tol:.0e}), statistics relative {raw_rel:.3e}; a second "
            f"run gives the same bits: {torch.equal(got, again)}"
        )
        ok = bool(torch.isfinite(got).all()) and rel <= tol and raw_rel <= tol and torch.equal(got, again)
        expect(ok, f"B12 {dtype} {shape} -> {co} disagrees with the plain version: {rel}, statistics {raw_rel}")
        flops = 2.0 * N * H * W * 9 * C * co
        size = x.element_size()
        n_bytes = (x.numel() + w.numel() + got.numel() + (res.numel() if residual else 0)) * size + co * 4
        if norm:
            n_bytes += (stats.numel() + (2 * C if affine else 0)) * 4
        if with_stats:
            n_bytes += raw.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, flops, PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS)
        xin = x
        if norm:
            xin = fused_conv._normalize_silu(
                x.float(), stats[:, None, None, 0, :], stats[:, None, None, 1, :], scale, bias
            ).to(dtype)
        x_lib = xin.permute(0, 3, 1, 2)  # the channels-last NCHW view cuDNN takes without a copy
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = b.to(dtype)

        def library(a=(x_lib, w_lib, b_lib)):
            with fused_conv.cudnn_tf32(False):
                return F.conv2d(a[0], a[1], a[2], 1, 1)

        def kernel(a=args, s=with_stats):
            return fused_conv.conv3x3_gn_silu_forward(*a, out_stats=s)

        iters = 50 if flops < 2e11 else 5
        timing: dict = {}
        timed(timing, "ms", kernel, iters)
        timed(timing, "plain_ms", lambda a=args, s=with_stats: _plain_b12(*a, out_stats=s), iters)
        timed(timing, "library_ms", library, iters)
        timing["host_us"] = host_us(kernel)
        geometry = (
            f"; plan: BN {plan.bn} x {plan.n_tiles}, {plan.block_rows} rows a tile in strips of {plan.strip_w}, "
            f"{plan.b_stages} weight stages, {plan.smem} bytes of shared memory"
            if plan.route == "wgmma" else ""
        )
        print(
            f"B12 {shape} -> {co} {dtype} (card time, CUDA-graph replay of {iters}): {timing['ms'] * 1e3:.2f} us "
            f"kernel ({flops / timing['ms'] / 1e9:.1f} TFLOP/s), {timing['plain_ms'] * 1e3:.2f} us plain, library "
            f"{timing['library_ms'] * 1e3:.2f} us (F.conv2d + bias, TF32 off, on the normalized input: the conv "
            f"alone), bound {b_ms * 1e3:.2f} us ({b_by}, {flops / 1e9:.1f} GFLOP); host {timing['host_us']:.1f} us "
            f"a launch (median of 200){geometry}"
        )
        if "conv3x3_gn_silu_forward" not in rows:  # the row keeps the first shape's numbers
            rows["conv3x3_gn_silu_forward"] = {
                "name": "conv3x3_gn_silu_forward",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/fused_conv.cu",
                "replaces": "skrample_tpu/ops/fused_conv.py:251",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                **{k: v for k, v in timing.items() if k != "host_us"},
            }
        del x, w, got, want, again, args, xin, x_lib, res
    return rows


def _wrappers() -> dict:
    "Every kernel wrapper, by the name its row carries."
    from skrample_tpu_torch.ops import adaln, flash_attention, fused, fused_conv, groupnorm, quant, rope

    return {
        "fused_step_cuda": fused.fused_step_cuda,
        "flash_attention_qkv_forward": flash_attention.flash_attention_qkv_forward,
        "adaln_forward": adaln.adaln_forward,
        "flash_attention_qkv_forward_lse": flash_attention.flash_attention_qkv_forward_lse,
        "flash_attention_qkv_backward": flash_attention.flash_attention_qkv_backward,
        "adaln_backward": adaln.adaln_backward,
        "quantize_rows": quant.quantize_rows,
        "rope_qk_norm_forward": rope.rope_qk_norm_forward,
        "groupnorm_forward": groupnorm.groupnorm_forward,
        "flash_attention_pairs_forward": flash_attention.flash_attention_pairs_forward,
        "conv3x3_gn_silu_forward": fused_conv.conv3x3_gn_silu_forward,
        "flash_attention_forward": flash_attention.flash_attention_forward,
        "flash_attention_packed_forward": flash_attention.flash_attention_packed_forward,
        "tconv_causal_gn_silu_forward": fused_conv.tconv_causal_gn_silu_forward,
        "flash_attention_block_stats": flash_attention.flash_attention_block_stats,
    }


def _counters() -> dict[str, int]:
    """Every wrapper's launches since the counters were reset.  Every K2, K4, K5, B9, B10 and B11 launch must
    have gone through the Hopper kernels (route wgmma): checked here, at each read, so every path phase
    holds its attention launches to their routes exactly."""
    wrappers = _wrappers()
    for name in ATTENTION_SM90:
        fn = wrappers[name]
        if hasattr(fn, "routes"):  # not where a phase has swapped the wrapper for its plain version
            expect(fn.routes == {"wgmma": fn.launches}, f"{name}: {fn.launches} launches, by route {fn.routes}")
    return {name: fn.launches for name, fn in wrappers.items()}


def _reset_counters() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)


def _routes() -> dict[str, dict[str, int]]:
    "B12's and B13's launches by route (wgmma, mma.sync, f32) since the counters were reset."
    from skrample_tpu_torch.ops import fused_conv

    return {
        "conv3x3_gn_silu_forward": dict(fused_conv.conv3x3_gn_silu_forward.routes),
        "tconv_causal_gn_silu_forward": dict(fused_conv.tconv_causal_gn_silu_forward.routes),
    }


def _attention_routes() -> str:
    "The attention wrappers' launches by route since the counters were reset, for a phase's log."
    wrappers = _wrappers()
    return ", ".join(f"{name} {wrappers[name].routes}" for name in ATTENTION_SM90 if wrappers[name].launches)


def host_us(fn, calls: int = 200) -> float:
    "A wrapper's host time per launch: the median over ``calls`` eager calls (host clock, no synchronize)."
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 20 == 19:
            torch.cuda.synchronize()  # keep the launch queue short
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


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
    per_dispatch = dict.fromkeys(_wrappers(), 0)
    per_dispatch.update(
        fused_step_cuda=STEPS, flash_attention_qkv_forward=DEPTH * STEPS, adaln_forward=(2 * DEPTH + 1) * STEPS
    )
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
        print(f"slice: attention launches by route: {_attention_routes()}")
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
    return launches, dict(zip(SEEDS, outs))


def _relative_fro(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


TRAIN_GROUPS = (
    ("K3 adaln", ("adaln_kernel",)),
    ("K4 flash_qkv_lse", ("flash_qkv_sm90_kernel",)),
    ("K5 dq kernel", ("flash_bwd_dq_sm90_kernel",)),
    ("K5 dkv kernel", ("flash_bwd_dkv_sm90_kernel",)),
    ("K6 adaln_bwd", ("adaln_bwd_kernel", "adaln_bwd_reduce_kernel")),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
    ("AdamW + EMA", ("multi_tensor_apply",)),
)


def _train_group(kernel: str) -> str:
    lowered = kernel.lower()
    for label, needles in TRAIN_GROUPS:
        if any(n in lowered for n in needles):
            return label
    return "other"


def training_phase(card: str) -> dict[str, int]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skrample_tpu_torch import training
    from skrample_tpu_torch.models.checkpoint import load_params, save_params
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.models.ema import ema_init
    from skrample_tpu_torch.ops import adaln, flash_attention

    dev = torch.device("cuda")
    config = DiTConfig(
        dim=512, depth=DEPTH, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash"
    )
    tree = random_param_tree(config, seed=0)
    model = DiT(config, device=dev).load_jax_params(tree)
    opt = training.make_optimizer(model)
    ema = ema_init(model)
    data = training.synthetic_dataset(64, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [training.draw_batch(data, 4, gen) for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    per_step = dict.fromkeys(_wrappers(), 0)
    per_step.update(
        adaln_forward=2 * DEPTH + 1,
        flash_attention_qkv_forward_lse=DEPTH,
        flash_attention_qkv_backward=DEPTH,
        adaln_backward=2 * DEPTH + 1,
    )

    for step in range(TRAIN_WARMUP):
        training.train_step(model, opt, ema, *batches[step], step=step)
    torch.cuda.synchronize()
    params_before = [p.detach().clone() for p in model.parameters()]
    ema_before = [e.clone() for e in ema.values()]

    # ---- the main path: 20 steps, counters from 0 ----
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    times, losses = [], []
    for step in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(training.train_step(model, opt, ema, *batches[step], step=step))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    print(f"train: launches {launches} over {TRAIN_STEPS} steps (per step expected {per_step})")
    print(f"train: attention launches by route: {_attention_routes()}")
    for name, count in launches.items():
        want = per_step[name] * TRAIN_STEPS
        expect(count == want, f"train: {name} launched {count} times, expected {want}")
    losses = torch.stack(losses).tolist()
    print(f"train: loss {losses[0]:.4f} -> {losses[-1]:.4f} over the timed steps")
    expect(all(map(math.isfinite, losses)), f"train: non-finite loss {losses}")
    expect(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()), "train: non-finite gradient")
    moved = sum(not torch.equal(a, p) for a, p in zip(params_before, model.parameters()))
    ema_moved = sum(not torch.equal(a, e) for a, e in zip(ema_before, ema.values()))
    n_params = len(params_before)
    print(f"train: {moved} of {n_params} parameter tensors moved, {ema_moved} of {n_params} EMA tensors moved")
    expect(moved == n_params and ema_moved == n_params, "train: parameters or EMA did not move")
    print(
        f"train: step time median {statistics.median(times) * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}; {TRAIN_STEPS} steps, batch 4 of 4x64x64, DiT-512/8 bf16; {card})"
    )
    print(f"train: peak device memory {peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated; {card})")

    # ---- where a step's card time goes: 3 more steps under torch.profiler ----
    traced = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(traced):
            step = TRAIN_WARMUP + TRAIN_STEPS + i
            training.train_step(model, opt, ema, *batches[i], step=step)
        torch.cuda.synchronize()
    card_ms: dict[str, float] = {}
    card_launches: dict[str, int] = {}
    others: dict[str, float] = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        # a user annotation on the card's timeline (AdamW's "Optimizer.step") spans kernels counted already
        if evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0 and not evt.is_user_annotation:
            label = _train_group(evt.key)
            card_ms[label] = card_ms.get(label, 0.0) + dev_us / 1e3 / traced
            card_launches[label] = card_launches.get(label, 0) + evt.count
            if label == "other":
                others[evt.key[:100]] = others.get(evt.key[:100], 0.0) + dev_us / 1e3 / traced
    busy = sum(card_ms.values())
    median = statistics.median(times) * 1e3
    for label in sorted(card_ms, key=card_ms.get, reverse=True):
        per_step_launches = card_launches[label] / traced
        print(f"train profile: {label:>16} {card_ms[label]:8.3f} ms/step on the card, {per_step_launches:g} launches/step")
    print(
        f"train profile: card busy {busy:.3f} ms of the {median:.2f} ms median step: "
        f"idle {100 * (1 - busy / median):.1f}%; "
        f"{sum(card_launches.values()) / traced:g} kernel launches per step ({card})"
    )
    for name in sorted(others, key=others.get, reverse=True)[:6]:
        print(f"train profile: other, largest: {others[name]:.3f} ms/step  {name}")
    # one K5 call launches both of its kernels: the trace must show each once per block and step
    for label in ("K5 dq kernel", "K5 dkv kernel"):
        got = card_launches.get(label, 0)
        want = DEPTH * traced
        expect(got == want, f"train profile: {label} ran {got} times in {traced} steps, expected {want}")

    # ---- one step through the kernels against the same step through the plain versions ----
    x0, noise, sigma = batches[0]
    plain_versions = (
        (flash_attention, "flash_attention_qkv_forward_lse", flash_attention._qkv_reference_lse),
        (flash_attention, "flash_attention_qkv_backward", flash_attention._qkv_backward_reference),
        (adaln, "adaln_forward", adaln.adaln_reference),
        (adaln, "adaln_backward", adaln.adaln_backward_reference),
    )
    grads, step_losses = [], []
    for plain in (False, True):
        fresh = DiT(config, device=dev).load_jax_params(tree)
        _reset_counters()
        with contextlib.ExitStack() as patches:
            for module, name, fn in plain_versions if plain else ():
                patches.enter_context(mock.patch.object(module, name, fn))
            loss = training.flow_matching_loss(fresh, x0, noise, sigma)
            loss.backward()
        torch.cuda.synchronize()
        counts = _counters()
        want = dict.fromkeys(per_step, 0) if plain else per_step
        expect(counts == want, f"train: the {'plain' if plain else 'kernel'} step launched {counts}, expected {want}")
        step_losses.append(loss.item())
        grads.append([p.grad for p in fresh.parameters()])
    loss_rel = abs(step_losses[0] - step_losses[1]) / abs(step_losses[1])
    grad_rel = [_relative_fro(a, b) for a, b in zip(*grads)]
    names = [name for name, _ in model.named_parameters()]
    worst = max(range(len(grad_rel)), key=grad_rel.__getitem__)
    print(
        f"train: kernels vs plain versions, one step: loss {step_losses[0]:.6f} vs {step_losses[1]:.6f}, relative "
        f"{loss_rel:.3e} (tolerance 1e-2); grads relative Frobenius max {grad_rel[worst]:.3e} ({names[worst]}), "
        f"median {statistics.median(grad_rel):.3e} over {len(grad_rel)} tensors (tolerance 5e-2, bf16)"
    )
    expect(loss_rel <= 1e-2, f"train: kernel loss differs from plain by {loss_rel}")
    expect(all(bool(torch.isfinite(a).all()) for a in grads[0]), "train: non-finite kernel-path gradient")
    expect(max(grad_rel) <= 5e-2, f"train: kernel gradient {names[worst]} differs from plain by {grad_rel[worst]}")

    # ---- the trained parameters through an .npz into a fresh DiT: the same forward, bit for bit ----
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dit.npz"
        save_params(path, model.param_tree())
        restored = DiT(config, device=dev).load_jax_params(load_params(path))
    with torch.no_grad():
        x = torch.randn((2, 4, 64, 64), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        t = torch.tensor([500.0, 20.0], device=dev)
        same = torch.equal(model(x, t), restored(x, t))
    print(f"train: .npz round trip of the trained parameters, forward bit-identical: {same}")
    expect(same, "train: the restored model's forward differs")
    return launches


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()


def int8_dit_phase(card: str, bf16_outputs: dict) -> dict[str, int]:
    "Phase 5: the phase-3 DiT-512/8 with int8 block weights serves the same 6 requests."
    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    config = DiTConfig(
        dim=512, depth=DEPTH, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash"
    )
    model = DiT(config, device="cuda").load_jax_params(random_param_tree(config, seed=0))
    model.requires_grad_(False)
    int8 = model.quantize_params()
    per_dispatch = dict.fromkeys(_wrappers(), 0)
    per_dispatch.update(
        fused_step_cuda=STEPS,
        flash_attention_qkv_forward=DEPTH * STEPS,
        adaln_forward=(2 * DEPTH + 1) * STEPS,
        quantize_rows=4 * DEPTH * STEPS,  # qkv, proj, mlp_in, mlp_out of every block
    )
    engine = ServingEngine(
        int8.as_sampleable(),
        item_shape=(4, 64, 64),
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
        engine.generate(99).cpu()
        batches_before = engine.stats.batches
        torch.cuda.synchronize()
        _reset_counters()
        first = [engine.submit(s) for s in SEEDS[:4]]
        outs = [f.result() for f in first]
        second = [engine.submit(s) for s in SEEDS[4:]]
        outs += [f.result() for f in second]
        outs = [o.cpu() for o in outs]
        torch.cuda.synchronize()
        launches = _counters()
        dispatches = engine.stats.batches - batches_before
        print(f"int8 DiT: 6 requests in {dispatches} dispatches; launches {launches} (per dispatch {per_dispatch})")
        print(f"int8 DiT: attention launches by route: {_attention_routes()}")
        expect(dispatches == 2, f"int8 DiT: expected 2 dispatches (4 + 2), got {dispatches}")
        for name, count in launches.items():
            expect(count == per_dispatch[name] * dispatches, f"int8 DiT: {name} launched {count} times")
        cosines = [_cosine(o, bf16_outputs[seed]) for seed, o in zip(SEEDS, outs)]
        print(f"int8 DiT: cosine to the bf16 output of the same request: min {min(cosines):.6f} (bound 0.99)")
        expect(all(bool(torch.isfinite(o).all()) for o in outs), "int8 DiT: non-finite output")
        expect(min(cosines) > 0.99, f"int8 DiT: cosine to bf16 {min(cosines)} <= 0.99")

        engine.max_delay_s = 2e-3
        solo_s, batch_s = [], []
        for i in range(3):
            t0 = time.perf_counter()
            engine.generate(200 + i).cpu()
            solo_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for f in [engine.submit(300 + 4 * i + j) for j in range(4)]:
                f.result().cpu()
            batch_s.append(time.perf_counter() - t0)
        print(f"int8 DiT: request latency, bucket 1: {min(solo_s) * 1e3:.2f} ms (min of 3; {card})")
        best = min(batch_s)
        print(f"int8 DiT: batch of 4 latency: {best * 1e3:.2f} ms, {4 / best:.2f} img/s (min of 3; {card})")
    return launches


FLUX_GROUPS = (
    ("K1 fused_step", ("fused_step_kernel",)),
    ("K2 flash_qkv", ("flash_qkv_sm90_kernel",)),
    ("K3 adaln", ("adaln_kernel",)),
    ("B6 quant_rows", ("quant_rows_kernel",)),
    ("B7 rope_qk_norm", ("rope_qk_norm_kernel",)),
    ("int8 matmul", ("imma", "i8i8", "s8s8", "int8")),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
)


def _group(kernel: str, groups: tuple = FLUX_GROUPS) -> str:
    lowered = kernel.lower()
    for label, needles in groups:
        if any(n in lowered for n in needles):
            return label
    return "other"


def _traced_dispatch(
    run, label: str, median_s: float, card: str, groups: tuple = FLUX_GROUPS, share: str | None = None
) -> dict[str, int]:
    """The card's time by kernel group over one traced dispatch, and its busy share of the median untraced
    one; ``share`` names a group whose share of the busy time gets a line of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        run()
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    card_ms: dict[str, float] = {}
    card_launches: dict[str, int] = {}
    names: dict[str, float] = {}
    kernel_counts: dict[str, int] = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0 and not evt.is_user_annotation:
            group = _group(evt.key, groups)
            card_ms[group] = card_ms.get(group, 0.0) + dev_us / 1e3
            card_launches[group] = card_launches.get(group, 0) + evt.count
            names[evt.key[:90]] = names.get(evt.key[:90], 0.0) + dev_us / 1e3
            kernel_counts[evt.key] = kernel_counts.get(evt.key, 0) + evt.count
    busy = sum(card_ms.values())
    for group in sorted(card_ms, key=card_ms.get, reverse=True):
        print(
            f"{label} profile: {group:>16} {card_ms[group]:10.2f} ms on the card ({100 * card_ms[group] / busy:4.1f}% "
            f"of busy), {card_launches[group]} launches"
        )
    # tracing slows the host, not the kernels: the idle share is against the median untraced dispatch
    print(
        f"{label} profile: card busy {busy:.2f} ms of the {median_s * 1e3:.2f} ms median untraced dispatch: idle "
        f"{100 * (1 - busy / (median_s * 1e3)):.1f}% (the traced one took {traced_s * 1e3:.2f} ms); "
        f"{sum(card_launches.values())} kernel launches ({card})"
    )
    for name in sorted(names, key=names.get, reverse=True)[:6]:
        print(f"{label} profile: largest: {names[name]:.2f} ms  {name}")
    if share is not None:
        ms = card_ms.get(share, 0.0)
        print(
            f"{label} profile: {share} took {ms:.2f} ms of the card's {busy:.2f} busy ms ({100 * ms / busy:.1f}%) "
            f"in {card_launches.get(share, 0)} launches ({card})"
        )
    return {name: count for name, count in kernel_counts.items()}


def _clocks() -> str:
    "The card's SM clock (now and at most), power draw and limit, and temperature, as nvidia-smi reads them."
    query = "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True, text=True, timeout=60
    )
    return f"{query}: {smi.stdout.strip()}"


def _plain_rope(qkv, q_gain, k_gain, cos, sin, heads, eps=1e-6, in_place=False):
    from skrample_tpu_torch.ops import rope

    return rope.rope_qk_norm_reference(qkv, q_gain, k_gain, cos, sin, heads, eps)


def flux_phase(card: str) -> tuple[dict[str, int], dict[str, int]]:
    """Phase 6: FLUX.1-dev at its published widths and depth, bf16 then int8; returns each
    configuration's main-path launches."""
    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.flux import Flux, FluxConfig, flux_forward_flops
    from skrample_tpu_torch.ops import adaln, flash_attention, quant, rope
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    # FLUX.1-dev transformer/config.json: 19 + 38 layers, 24 heads of 128, joint_attention_dim 4096, pooled 768
    config = FluxConfig(
        dim=3072, heads=24, depth=19, single_depth=38, context_dim=4096, pooled_dim=768, guidance=True,
        compute_dtype=torch.bfloat16, attention="flash",
    )
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    model = Flux(config, device=dev, generator=gen, dtype=torch.bfloat16)
    model.reset_parameters(gen, noise=0.02)  # scripts/bench_flux.py's recipe: every leaf random
    model.requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(
        f"flux: FLUX.1-dev widths, {config.depth} double + {config.single_depth} single blocks, {n_params / 1e9:.3f}B "
        f"parameters in bf16 drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated"
    )
    item_shape = (16, 128, 128)  # a 1024x1024 image through the 8x VAE: 4096 image tokens at patch 2
    txt = 512
    cgen = torch.Generator(dev).manual_seed(1)
    contexts = [
        (torch.randn((txt, config.context_dim), generator=cgen, device=dev),
         torch.randn((config.pooled_dim,), generator=cgen, device=dev))
        for _ in range(2)
    ]
    flops = flux_forward_flops(config, 1, 128, 128, txt)
    per_forward = dict.fromkeys(_wrappers(), 0)
    per_forward.update(
        flash_attention_qkv_forward=config.depth + config.single_depth,
        adaln_forward=4 * config.depth + config.single_depth + 1,
        rope_qk_norm_forward=2 * config.depth + config.single_depth,
    )

    def serve(fn, label: str, requests: list, int8: bool) -> tuple[dict[str, int], list]:
        "The main path (counters from 0), then latency and throughput medians and one traced dispatch."
        want = dict(per_forward, fused_step_cuda=1)
        if int8:
            want["quantize_rows"] = 8 * config.depth + 3 * config.single_depth
        engine = ServingEngine(
            fn,
            item_shape=item_shape,
            sampler=structured.DPM(order=2),
            schedule=scheduling.FlowShift(scheduling.Linear()),
            model_transform=models.FlowModel(),
            steps=FLUX_STEPS,
            dtype=torch.float32,
            buckets=(1, 2),
            conditioned=True,
            device=dev,
        )
        with engine:
            torch.cuda.reset_peak_memory_stats()
            batches_before = engine.stats.batches
            torch.cuda.synchronize()
            _reset_counters()
            solo_s, pair_s = [], []
            t0 = time.perf_counter()
            futs = [engine.submit(seed, context=ctx) for seed, ctx in requests[:2]]
            outs = [f.result().cpu() for f in futs]
            pair_s.append(time.perf_counter() - t0)
            if len(requests) > 2:
                t0 = time.perf_counter()
                outs.append(engine.generate(requests[2][0], context=requests[2][1]).cpu())
                solo_s.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            launches = _counters()
            dispatches = engine.stats.batches - batches_before
            forwards = FLUX_STEPS * dispatches
            print(f"{label}: {len(requests)} requests in {dispatches} dispatches ({engine.stats.bucket_counts})")
            print(f"{label}: launches {launches} (per forward expected {want}, {forwards} forwards)")
            print(f"{label}: attention launches by route: {_attention_routes()}")
            expect(dispatches == (len(requests) + 1) // 2, f"{label}: {dispatches} dispatches")
            for name, count in launches.items():
                expect(count == want[name] * forwards, f"{label}: {name} launched {count}, expected {want[name] * forwards}")
            for o in outs:
                expect(tuple(o.shape) == item_shape and bool(torch.isfinite(o).all()), f"{label}: bad output")
            peak = torch.cuda.max_memory_allocated()
            print(f"{label}: after the main path, {_clocks()}")

            for i in range(FLUX_REPEATS - len(solo_s)):
                t0 = time.perf_counter()
                engine.generate(500 + i, context=requests[0][1]).cpu()
                solo_s.append(time.perf_counter() - t0)
            for i in range(FLUX_REPEATS - len(pair_s)):
                t0 = time.perf_counter()
                for f in [engine.submit(600 + 2 * i + j, context=requests[j][1]) for j in range(2)]:
                    f.result().cpu()
                pair_s.append(time.perf_counter() - t0)
            solo, pair = statistics.median(solo_s), statistics.median(pair_s)
            print(
                f"{label}: request latency, bucket 1: median {solo * 1e3:.1f} ms of {len(solo_s)} "
                f"({', '.join(f'{v * 1e3:.1f}' for v in solo_s)}); {flops * FLUX_STEPS / solo / 1e12:.1f} TFLOP/s of "
                f"model products ({card})"
            )
            print(
                f"{label}: batch of 2: median {pair * 1e3:.1f} ms, {2 / pair:.4f} img/s "
                f"({', '.join(f'{v * 1e3:.1f}' for v in pair_s)}; {card})"
            )
            print(f"{label}: peak device memory over the main path {peak / 2**30:.2f} GiB ({card})")
            _traced_dispatch(
                lambda: engine.generate(700, context=requests[0][1]).cpu(),
                f"{label} bucket 1",
                solo,
                card,
                share="K2 flash_qkv",
            )
        return launches, outs

    with torch.inference_mode():  # warm-up forwards at both bucket sizes: library handles and heuristics
        for b in (1, 2):
            x = torch.randn((b, *item_shape), device=dev)
            ctx = torch.stack([contexts[0][0]] * b), torch.stack([contexts[0][1]] * b)
            model(x, torch.tensor(500.0, device=dev), *ctx, guidance=3.5)
        torch.cuda.synchronize()

    # ---- bf16: requests A and B together, then A again alone ----
    requests = [(1, contexts[0]), (2, contexts[1]), (1, contexts[0])]
    bf16_launches, bf16_outs = serve(model.as_served(guidance=3.5), "flux bf16", requests, int8=False)
    packing = _relative(bf16_outs[2], bf16_outs[0])
    print(f"flux bf16: packing invariance, request A alone vs packed: relative max err {packing:.3e} (tol 5e-2, bf16)")
    expect(packing <= 5e-2, f"flux bf16: packing changes request A by {packing}")

    # ---- one forward at batch 1 through the kernels, then through the plain versions ----
    fgen = torch.Generator(dev).manual_seed(2)
    x = torch.randn((1, *item_shape), generator=fgen, device=dev)
    args = (x, torch.tensor(500.0, device=dev), contexts[0][0][None], contexts[0][1][None])
    with torch.inference_mode():
        _reset_counters()
        got = model(*args, guidance=3.5)
        kernel_counts = _counters()
        with (
            mock.patch.object(flash_attention, "flash_attention_qkv_forward", flash_attention._qkv_reference),
            mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
            mock.patch.object(rope, "rope_qk_norm_forward", _plain_rope),
        ):
            want = model(*args, guidance=3.5)
        torch.cuda.synchronize()
    expect(kernel_counts == per_forward, f"flux: one forward launched {kernel_counts}, expected {per_forward}")
    expect(_counters() == kernel_counts, f"flux: the plain forward launched kernels: {_counters()}")
    vs_plain = _relative(got, want)
    print(f"flux bf16: one forward through the kernels vs the plain versions: relative max err {vs_plain:.3e} (tol 5e-2)")
    expect(bool(torch.isfinite(want).all()) and vs_plain <= 5e-2, f"flux: kernel forward differs by {vs_plain}")

    # ---- the int8 model beside the bf16 one: requests A and B ----
    t0 = time.perf_counter()
    int8 = model.quantize_params()
    torch.cuda.synchronize()
    print(
        f"flux int8: quantized in {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated with the bf16 model"
    )
    int8_launches, int8_outs = serve(int8.as_served(guidance=3.5), "flux int8", requests[:2], int8=True)
    cosines = [_cosine(a, b) for a, b in zip(int8_outs, bf16_outs)]
    print(f"flux int8: cosine to the bf16 output of the same request: {', '.join(f'{c:.6f}' for c in cosines)} (> 0.99)")
    expect(min(cosines) > 0.99, f"flux int8: cosine to bf16 {min(cosines)} <= 0.99")
    print(f"flux: phase took {time.perf_counter() - phase_t0:.1f} s")
    return bf16_launches, int8_launches


SDXL_GROUPS = (
    ("B12 convs", ("conv3x3_sm90_kernel", "conv3x3_f32_kernel", "conv3x3_bf16_kernel", "conv_stats_reduce_kernel")),
    ("K1 fused_step", ("fused_step_kernel",)),
    ("B8 groupnorm", ("gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")),
    ("B10 attention", ("flash_strided_sm90_kernel",)),
    ("layout copies", ("nchwtonhwc", "nhwctonchw")),
    ("cuDNN convs", ("fprop", "implicit_gemm", "conv", "cudnn", "winograd")),
    ("plain cross-attention", ("softmax", "sgemm", "f32f32_f32f32", "gemv2t", "gemmsn")),
    ("cuBLAS dense", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
)


def _conv_rounding(gen) -> None:
    """ROADMAP C7 on the card: the port's bf16 ``_conv`` (B12, norm and statistics off) at SDXL's 640-channel
    3x3 conv, and beside it cuDNN's bf16 conv with a bf16 bias (the route before the repair), against one
    rounding of the f32 sum of the same bf16 operands plus the f32 bias (the JAX package's ``_conv``; cuDNN
    in f32, TF32 off).  The share of outputs that differ, and the largest distance in bf16 ulps over all
    outputs and over those whose sum is not a cancellation (|sum| >= 2^-11 of the sum of |terms|): where
    5760 terms cancel far below their scale, two f32 summation orders round many ulps apart whatever the
    route, so the 1-ulp bound is held where it measures the rounding."""
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch.models.unet import _Conv, _conv, _ConvSpec
    from skrample_tpu_torch.ops.fused_conv import cudnn_tf32

    dev = torch.device("cuda")
    conv = _Conv(_ConvSpec(3, 640, 640), torch.bfloat16).to_empty(device=dev)
    with torch.no_grad():
        conv.w.copy_(torch.randn(conv.w.shape, generator=gen, device=dev) / 80)
        conv.b.copy_(0.5 * torch.randn(640, generator=gen, device=dev))
        x = torch.randn((4, 64, 64, 640), generator=gen, device=dev).to(torch.bfloat16)
        port = _conv(conv, x, torch.bfloat16).permute(0, 3, 1, 2)
        xn = x.permute(0, 3, 1, 2)  # channels-last NCHW
        before = F.conv2d(xn, conv.w, conv.b, 1, 1)
        w32, b32 = conv.w.float(), conv.b.float()
        with cudnn_tf32(False):
            exact = F.conv2d(xn.float(), w32, b32, 1, 1)
            terms = F.conv2d(xn.float().abs(), w32.abs(), b32.abs(), 1, 1)
    once = exact.to(torch.bfloat16)
    settled = exact.abs() >= terms / 2048
    torch.cuda.synchronize()
    results = {}
    for label, got in (("the port's _conv (B12)", port), ("cuDNN bf16 with a bf16 bias", before)):
        ulps = _ulp_map(got, once)
        results[label] = share, worst = (ulps > 0).float().mean().item(), ulps[settled].max().item()
        print(
            f"sdxl C7: {label}, 640->640 3x3 at (4, 64, 64): {100 * share:.3f}% of outputs differ from one "
            f"rounding of the f32 sum; max {ulps.max().item():g} ulp over all outputs, {worst:g} ulp over the "
            f"{100 * settled.float().mean().item():.2f}% that are not cancellations"
        )
    share, worst = results["the port's _conv (B12)"]
    expect(share <= 1e-2 and worst <= 1, f"sdxl C7: the port's conv differs from one rounding: {share}, {worst} ulp")


def _layout_audit(run) -> None:
    """Every convolution of one forward: are its input and weight channels-last?  And every copy
    of a 4-D tensor that changes its stride order, by op and shape (a NCHW <-> NHWC relayout)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    def order(t) -> tuple[int, ...]:
        return tuple(sorted(range(t.ndim), key=lambda i: (-t.stride(i), i)))

    class Audit(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.convs = 0
            self.not_cl: list[str] = []
            self.relayouts: dict[str, int] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            op = func.overloadpacket
            if op in (aten.conv2d, aten.convolution):  # under inference_mode the composite op arrives whole
                self.convs += 1
                for label, t in (("input", args[0]), ("weight", args[1])):
                    if not t.is_contiguous(memory_format=torch.channels_last):
                        self.not_cl.append(f"{label} {tuple(t.shape)}")
            elif op in (aten._to_copy, aten.clone, aten.copy_, aten.to, aten.contiguous):
                src, dst = (args[1], args[0]) if op is aten.copy_ else (args[0], out)
                if src.ndim == 4 and min(src.shape) > 1 and order(src) != order(dst):
                    key = f"{func.__name__} {tuple(src.shape)}"
                    self.relayouts[key] = self.relayouts.get(key, 0) + 1
            return out

    audit = Audit()
    with audit:
        run()
    print(
        f"sdxl layout: {audit.convs} convolutions in one CFG forward, {len(audit.not_cl)} with an operand that is not "
        f"channels-last {audit.not_cl[:4]}; 4-D copies that change the stride order: "
        f"{sum(audit.relayouts.values())} {audit.relayouts}"
    )
    expect(not audit.not_cl, f"sdxl: convolutions outside channels-last: {audit.not_cl[:4]}")


def sdxl_phase(card: str) -> tuple[dict[str, int], dict]:
    """Phase 7: SDXL base at its published widths and depth, bf16, with classifier-free guidance;
    returns the main path's launches and what phase 8 serves with (the UNet, prompt features, the
    per-forward launches)."""
    import numpy as np
    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.conditioning import guided_mix
    from skrample_tpu_torch.models.sdxl import SDXLStack
    from skrample_tpu_torch.models.unet_cond import CondUNet, CondUNetConfig, cond_unet_forward_flops
    from skrample_tpu_torch.ops import CompiledDenoiser, compile_sampler, flash_attention, fused_conv, groupnorm
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    sampler, schedule, transform = structured.DPM(order=2), scheduling.Karras(scheduling.Scaled()), models.NoiseModel()

    # ---- the compiled Karras(Scaled) trajectory: K1 on the card against the plain chain on the CPU ----
    compiled = compile_sampler(sampler, schedule, transform, SDXL_STEPS)
    x0 = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 4, 128, 128), dtype=np.float32))

    def toy(x, t, s, a):  # elementwise and IEEE on both devices: any difference is the step arithmetic
        return x * 0.25 - 0.125

    on_cpu = CompiledDenoiser.build(compiled, device="cpu").run(toy, x0)
    on_card = CompiledDenoiser.build(compiled, device=dev).run(toy, x0.to(dev)).cpu()
    traj = max_err(on_card, on_cpu)
    print(f"sdxl: 25-step DPM++2M / Karras(Scaled) / NoiseModel trajectory, K1 on the card vs the CPU: {traj:.3e}")
    expect(traj <= 1e-6 * on_cpu.abs().max().item(), f"sdxl: the compiled trajectory differs on the card by {traj}")

    _conv_rounding(torch.Generator(dev).manual_seed(3))

    # ---- the published UNet, bf16, every leaf random (standard init + 0.02 N(0, 1)) ----
    config = CondUNetConfig(compute_dtype=torch.bfloat16)  # stabilityai/stable-diffusion-xl-base-1.0 unet/config.json
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    unet = CondUNet(config, device=dev, generator=gen, dtype=torch.bfloat16)
    unet.reset_parameters(gen, noise=0.02)
    unet.requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in unet.parameters())
    print(
        f"sdxl: SDXL base UNet (widths {config.widths}, depths {config.transformer_layers}, heads {config.heads}), "
        f"{n_params / 1e9:.3f}B parameters in bf16 drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated"
    )
    item_shape = (4, 128, 128)  # a 1024x1024 image through the 8x VAE
    cgen = torch.Generator(dev).manual_seed(1)

    def features() -> tuple:
        return (torch.randn((77, config.context_dim), generator=cgen, device=dev),
                torch.randn((config.pooled_dim,), generator=cgen, device=dev))

    contexts = [features(), features()]
    uncond = features()
    stack = SDXLStack(unet)
    served = stack.as_served(SDXLStack.time_ids((1024, 1024), (0, 0), (1024, 1024), device=dev), 5.0, uncond)
    flops = 2 * cond_unet_forward_flops(config, 1, 128, 128, 77)  # one request's CFG forward: batch 2
    per_forward = dict.fromkeys(_wrappers(), 0)
    # B12: every stride-1 3x3 conv (conv_in, 2 a resnet: 6 down, 2 mid, 9 up; 2 upsamples; conv_out)
    per_forward.update(groupnorm_forward=46, flash_attention_pairs_forward=70, conv3x3_gn_silu_forward=38)
    want = dict(per_forward, fused_step_cuda=1)

    def cfg_forward(b: int):
        x = torch.randn((b, *item_shape), generator=cgen, device=dev)
        ctx = torch.stack([contexts[0][0]] * b), torch.stack([contexts[0][1]] * b)
        return lambda: served(x, torch.tensor(500.0, device=dev), None, None, ctx)

    with torch.inference_mode():  # warm-up CFG forwards at both bucket sizes: cuDNN and cuBLAS heuristics
        for b in (1, 2):
            cfg_forward(b)()
        torch.cuda.synchronize()

    engine = ServingEngine(
        served, item_shape=item_shape, sampler=sampler, schedule=schedule, model_transform=transform,
        steps=SDXL_STEPS, dtype=torch.float32, buckets=(1, 2), conditioned=True, device=dev,
    )
    with engine:
        # ---- the main path: requests A and B together, then A again alone ----
        torch.cuda.reset_peak_memory_stats()
        batches_before = engine.stats.batches
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        futs = [engine.submit(seed, context=ctx) for seed, ctx in ((1, contexts[0]), (2, contexts[1]))]
        outs = [f.result().cpu() for f in futs]
        pair_s = [time.perf_counter() - t0]
        t0 = time.perf_counter()
        outs.append(engine.generate(1, context=contexts[0]).cpu())
        solo_s = [time.perf_counter() - t0]
        torch.cuda.synchronize()
        launches = _counters()
        dispatches = engine.stats.batches - batches_before
        forwards = SDXL_STEPS * dispatches
        print(f"sdxl: 3 requests in {dispatches} dispatches ({engine.stats.bucket_counts})")
        print(f"sdxl: launches {launches} (per forward expected {want}, {forwards} CFG forwards)")
        print(f"sdxl: attention launches by route: {_attention_routes()}")
        expect(dispatches == 2, f"sdxl: {dispatches} dispatches, expected 2")
        for name, count in launches.items():
            expect(count == want[name] * forwards, f"sdxl: {name} launched {count}, expected {want[name] * forwards}")
        # B12's routes: conv_in (C = 4) takes the mma.sync kernel, the other 37 convs a forward the wgmma one
        routes = _routes()["conv3x3_gn_silu_forward"]
        want_routes = {"wgmma": 37 * forwards, "mma_sync": forwards, "f32": 0}
        print(f"sdxl: B12 launches by route {routes} (expected {want_routes})")
        expect(routes == want_routes, f"sdxl: B12 routes {routes}, expected {want_routes}")
        for o in outs:
            expect(tuple(o.shape) == item_shape and bool(torch.isfinite(o).all()), "sdxl: bad output")
        peak = torch.cuda.max_memory_allocated()
        print(f"sdxl: after the main path, {_clocks()}")

        packing = _relative(outs[2], outs[0])
        print(f"sdxl: packing invariance, request A alone vs packed: bit-equal {torch.equal(outs[2], outs[0])}")
        expect(torch.equal(outs[2], outs[0]), f"sdxl: packing changes request A by {packing}")

        for i in range(SDXL_REPEATS - 1):
            t0 = time.perf_counter()
            engine.generate(500 + i, context=contexts[0]).cpu()
            solo_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for f in [engine.submit(600 + 2 * i + j, context=contexts[j]) for j in range(2)]:
                f.result().cpu()
            pair_s.append(time.perf_counter() - t0)
        solo, pair = statistics.median(solo_s), statistics.median(pair_s)
        print(
            f"sdxl: request latency, bucket 1 (CFG: 2 images a forward): median {solo * 1e3:.1f} ms of {len(solo_s)} "
            f"({', '.join(f'{v * 1e3:.1f}' for v in solo_s)}); {flops * SDXL_STEPS / solo / 1e12:.1f} TFLOP/s of "
            f"model products ({flops / 1e12:.2f} TFLOP a CFG forward; {card})"
        )
        print(
            f"sdxl: batch of 2: median {pair * 1e3:.1f} ms, {2 / pair:.4f} img/s "
            f"({', '.join(f'{v * 1e3:.1f}' for v in pair_s)}; {card})"
        )
        print(f"sdxl: peak device memory over the main path {peak / 2**30:.2f} GiB ({card})")
        kernels = _traced_dispatch(
            lambda: engine.generate(700, context=contexts[0]).cpu(), "sdxl bucket 1", solo, card, SDXL_GROUPS
        )
        relayout = {k: n for k, n in kernels.items() if _group(k, SDXL_GROUPS) == "layout copies"}
        print(f"sdxl layout: NCHW<->NHWC conversion kernels in the traced dispatch: {sum(relayout.values())}")

    # ---- one CFG forward (the UNet over the doubled batch) through the kernels, then the plain versions ----
    with torch.inference_mode():
        _layout_audit(cfg_forward(1))
        x = torch.randn((1, *item_shape), generator=cgen, device=dev)
        args = (
            torch.cat([x, x]),
            torch.tensor([500.0, 500.0], device=dev),
            torch.stack([contexts[0][0], uncond[0]]),
            torch.stack([contexts[0][1], uncond[1]]),
            SDXLStack.time_ids((1024, 1024), (0, 0), (1024, 1024), device=dev).expand(2, 6),
        )
        _reset_counters()
        got = unet(*args)
        kernel_counts = _counters()
        with (
            mock.patch.object(groupnorm, "groupnorm_forward", groupnorm.groupnorm_reference),
            mock.patch.object(flash_attention, "flash_attention_pairs_forward", flash_attention._packed_reference),
            mock.patch.object(fused_conv, "conv3x3_gn_silu_forward", _plain_b12),
        ):
            plain = unet(*args)
        torch.cuda.synchronize()
    expect(kernel_counts == per_forward, f"sdxl: one CFG forward launched {kernel_counts}, expected {per_forward}")
    expect(_counters() == kernel_counts, f"sdxl: the plain forward launched kernels: {_counters()}")
    vs_plain = _relative(got, plain)
    guided = _relative(guided_mix(got[:1], got[1:], 5.0), guided_mix(plain[:1], plain[1:], 5.0))
    print(
        f"sdxl: one CFG forward through the kernels vs the plain versions: both branches relative max err "
        f"{vs_plain:.3e} (tol 5e-2); after the guidance-5 mix {guided:.3e} (the mix multiplies the branches' "
        f"difference by 5)"
    )
    expect(bool(torch.isfinite(plain).all()) and vs_plain <= 5e-2, f"sdxl: kernel forward differs by {vs_plain}")
    print(f"sdxl: phase took {time.perf_counter() - phase_t0:.1f} s")
    parts = {"unet": unet, "contexts": contexts, "uncond": uncond, "per_forward": per_forward}
    return launches, parts


# stabilityai/stable-diffusion-xl-base-1.0 vae/config.json (the fields the importer reads)
SDXL_VAE_CONFIG = {
    "in_channels": 3,
    "out_channels": 3,
    "latent_channels": 4,
    "block_out_channels": (128, 256, 512, 512),
    "layers_per_block": 2,
    "norm_num_groups": 32,
    "scaling_factor": 0.13025,
    "act_fn": "silu",
    "down_block_types": ("DownEncoderBlock2D",) * 4,
    "up_block_types": ("UpDecoderBlock2D",) * 4,
}
VAE_GROUPS = (
    ("B12 convs", ("conv3x3_sm90_kernel", "conv3x3_f32_kernel", "conv3x3_bf16_kernel", "conv_stats_reduce_kernel")),
    ("B8 groupnorm", ("gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")),
    ("cuDNN convs", ("fprop", "implicit_gemm", "conv", "cudnn", "winograd")),
    ("attention softmax", ("softmax",)),
    ("cuBLAS products", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
)


def vae_phase(card: str, parts: dict) -> dict[str, int]:
    """Phase 8: SDXL served to pixels.  The SDXL base VAE at its published widths (f32, drawn on the card)
    behind the phase-7 UNet: ``ServingEngine(stack.as_served(...), conditioned=True,
    postprocess=stack.decode)``; returns the main path's launches."""
    import dataclasses

    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.import_weights import vae_config
    from skrample_tpu_torch.models.sdxl import SDXLStack
    from skrample_tpu_torch.models.vae import VAE, fused_convs_per_decode, vae_decode_flops
    from skrample_tpu_torch.ops import fused_conv, groupnorm
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    config = dataclasses.replace(vae_config(SDXL_VAE_CONFIG), fused_decode=True)  # "auto" is unfused (C10)
    gen = torch.Generator(dev).manual_seed(8)
    vae = VAE(config, device=dev, generator=gen)
    vae.reset_parameters(gen, noise=0.02)
    vae.requires_grad_(False)
    n_params = sum(p.numel() for p in vae.parameters())
    per_decode = fused_convs_per_decode(config)
    flops = vae_decode_flops(config, 1, 128, 128)
    print(
        f"vae: SDXL base VAE (widths {config.widths()}, {config.blocks_per_level} blocks a level, groups "
        f"{config.groups}, {config.compute_dtype}), {n_params / 1e6:.2f}M parameters drawn on the card; "
        f"{per_decode} B12 convs a fused decode; a 1024x1024 decode is {flops / 1e12:.2f} TFLOP"
    )
    expect(per_decode == 31, f"vae: {per_decode} fused convs a decode, expected 31")
    stack = SDXLStack(parts["unet"], vae)
    contexts, uncond = parts["contexts"], parts["uncond"]
    served = stack.as_served(SDXLStack.time_ids((1024, 1024), (0, 0), (1024, 1024), device=dev), 5.0, uncond)
    zgen = torch.Generator(dev).manual_seed(9)

    def latents(b: int):
        return torch.randn((b, 4, 128, 128), generator=zgen, device=dev)

    with torch.inference_mode():  # warm-up decodes at both bucket sizes: cuDNN and cuBLAS heuristics
        for b in (1, 2):
            stack.decode(latents(b))
        torch.cuda.synchronize()
        _reset_counters()
        stack.decode(latents(1))
        one = _counters()
    want_one = dict.fromkeys(_wrappers(), 0)
    want_one.update(conv3x3_gn_silu_forward=31, groupnorm_forward=1)  # B8: the mid attention's norm
    print(f"vae: one decode call launched {one}")
    expect(one == want_one, f"vae: one decode launched {one}, expected {want_one}")

    engine = ServingEngine(
        served, item_shape=(4, 128, 128), sampler=structured.DPM(order=2),
        schedule=scheduling.Karras(scheduling.Scaled()), model_transform=models.NoiseModel(),
        steps=VAE_STEPS, dtype=torch.float32, buckets=(1, 2), conditioned=True, device=dev,
        postprocess=stack.decode,
    )
    with engine:
        # ---- the main path: requests A and B together, then A again alone, to pixels ----
        torch.cuda.reset_peak_memory_stats()
        batches_before = engine.stats.batches
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        futs = [engine.submit(seed, context=ctx) for seed, ctx in ((1, contexts[0]), (2, contexts[1]))]
        outs = [f.result().cpu() for f in futs]
        pair_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs.append(engine.generate(1, context=contexts[0]).cpu())
        solo_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        dispatches = engine.stats.batches - batches_before
    forwards = VAE_STEPS * dispatches
    want = {name: n * forwards for name, n in parts["per_forward"].items()}
    want["fused_step_cuda"] = VAE_STEPS * dispatches
    want["conv3x3_gn_silu_forward"] += per_decode * dispatches
    want["groupnorm_forward"] += dispatches
    print(f"vae: 3 requests to pixels in {dispatches} dispatches; launches {launches} (expected {want})")
    print(f"vae: attention launches by route: {_attention_routes()}")
    expect(dispatches == 2 and launches == want, f"vae: launches {launches}, expected {want}")
    for o in outs:
        expect(tuple(o.shape) == (3, 1024, 1024) and bool(torch.isfinite(o).all()), f"vae: bad pixels {o.shape}")
    same = torch.equal(outs[2], outs[0])
    print(
        f"vae: pixels (3, 1024, 1024) finite, range [{outs[0].min().item():.3f}, {outs[0].max().item():.3f}]; "
        f"request A alone == A packed, bit for bit: {same}"
    )
    expect(same, f"vae: packing changes request A's pixels by {_relative(outs[2], outs[0])}")
    print(
        f"vae: {VAE_STEPS}-step requests with the decode: a pair {pair_s * 1e3:.1f} ms, A alone "
        f"{solo_s * 1e3:.1f} ms; peak device memory {peak / 2**30:.2f} GiB over the main path ({card})"
    )

    # ---- the decode held against the unfused decode and against the plain versions ----
    unfused_vae = dataclasses.replace(config, fused_decode=False)
    with torch.inference_mode():
        z = latents(1)
        fused = stack.decode(z)
        vae.config = unfused_vae
        unfused = stack.decode(z)
        vae.config = config
        with (
            mock.patch.object(groupnorm, "groupnorm_forward", groupnorm.groupnorm_reference),
            mock.patch.object(fused_conv, "conv3x3_gn_silu_forward", _plain_b12),
        ):
            _reset_counters()
            plain = stack.decode(z)
            plain_counts = _counters()
        torch.cuda.synchronize()
    vs_unfused, vs_plain = _relative_fro(fused, unfused), _relative_fro(fused, plain)
    print(
        f"vae: fused decode vs the unfused decode of the same latents: {vs_unfused:.3e} relative Frobenius "
        f"(tolerance 1e-3: the uncentered against the centered variance, f32); through the kernels vs the plain "
        f"versions: {vs_plain:.3e} (tolerance 1e-3)"
    )
    expect(all(v == 0 for v in plain_counts.values()), f"vae: the plain decode launched kernels: {plain_counts}")
    expect(vs_unfused <= 1e-3 and vs_plain <= 1e-3, f"vae: decodes disagree: {vs_unfused}, {vs_plain}")

    # ---- decode times, fused and unfused, in turns; one traced fused decode by kernel group ----
    times: dict[str, list[float]] = {"fused": [], "unfused": []}
    with torch.inference_mode():
        for label in ("fused", "unfused", "unfused", "fused", "fused", "unfused"):
            vae.config = config if label == "fused" else unfused_vae
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stack.decode(z)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
        vae.config = config
        med = {label: statistics.median(v) for label, v in times.items()}
        for label, v in times.items():
            print(
                f"vae: {label} decode of one 1024x1024 image: median {med[label] * 1e3:.1f} ms of 3 "
                f"({', '.join(f'{t * 1e3:.1f}' for t in v)}); {flops / med[label] / 1e12:.1f} TFLOP/s ({card})"
            )
        _traced_dispatch(lambda: stack.decode(z), "vae fused decode", med["fused"], card, VAE_GROUPS)

        # ---- encode: a request's pixels back to latents ----
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        z_back = stack.encode_image(outs[0][None].to(dev))
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    print(
        f"vae: encode_image at 1024x1024: {tuple(z_back.shape)}, finite {bool(torch.isfinite(z_back).all())}, "
        f"{enc_s * 1e3:.1f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})"
    )
    expect(tuple(z_back.shape) == (1, 4, 128, 128) and bool(torch.isfinite(z_back).all()), "vae: bad encode")
    print(f"vae: phase took {time.perf_counter() - phase_t0:.1f} s")
    return launches


def ragged_kernels(gen) -> None:
    """ROADMAP C9: K2 at FLUX.1-dev's 1360x768 token count (512 text + 4080 image = 4592, not a multiple
    of 64) and K4 and K5 at a DiT training shape with N = 1000, each against its plain version, and each
    launched by the model-level dispatch ``flash_attention_qkv`` at that N (no plain fall-back); their
    card times beside the tiled shapes' rows."""
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch.ops import flash_attention

    dev = torch.device("cuda")
    # ---- K2 at (1, 4592, 9216), 24 heads of 128 ----
    B, N, H, d = 1, 4592, 24, 128
    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    got = flash_attention.flash_attention_qkv_forward(qkv, H)
    ref = flash_attention._qkv_reference(qkv, H)
    before = flash_attention.flash_attention_qkv_forward.launches
    with torch.inference_mode():
        via = flash_attention.flash_attention_qkv(qkv, H)
    launched = flash_attention.flash_attention_qkv_forward.launches - before
    torch.cuda.synchronize()
    err = max_err(got, ref)
    print(
        f"C9 K2 flash_attention_qkv_forward bf16 {tuple(qkv.shape)} (Flux 1360x768, N % 64 = {N % 64}): max_abs_err "
        f"{err:.3e} (tolerance 5.0e-03); flash_attention_qkv launched the kernel {launched} time(s), same bits: "
        f"{torch.equal(via, got)}"
    )
    expect(bool(torch.isfinite(got).all()) and err <= 5e-3, f"C9: K2 at N={N} disagrees with the plain attention")
    expect(launched == 1 and torch.equal(via, got), f"C9: flash_attention_qkv at N={N} did not launch K2 ({launched})")
    q, k, v = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)
    b_ms, b_by = bound_ms((qkv.numel() + got.numel()) * 2, 4 * B * H * N * N * d, PEAK_BF16_FLOPS)
    timing: dict = {}
    timed(timing, "ms", lambda: flash_attention.flash_attention_qkv_forward(qkv, H))
    timed(timing, "plain_ms", lambda: flash_attention._qkv_reference(qkv, H), 5)
    timed(timing, "library_ms", lambda: F.scaled_dot_product_attention(q, k, v))
    print(
        f"C9 K2 N {N} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel, "
        f"{timing['plain_ms'] * 1e3:.2f} us plain, library {timing['library_ms'] * 1e3:.2f} us, "
        f"bound {b_ms * 1e3:.2f} us ({b_by})"
    )
    del qkv, got, ref, via, q, k, v

    # ---- K4 and K5 at the DiT training shape with N = 1000: bf16 qkv (4, 1000, 1536), 4 heads ----
    B, N, H = 4, 1000, 4
    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    o, lse = flash_attention.flash_attention_qkv_forward_lse(qkv, H)
    ref_o, ref_lse = flash_attention._qkv_reference_lse(qkv, H)
    g = torch.randn((B, N, H * d), generator=gen, device=dev).to(torch.bfloat16)
    dqkv = flash_attention.flash_attention_qkv_backward(qkv, o, lse, g, H)
    want = flash_attention._qkv_backward_reference(qkv, o, lse, g, H)
    torch.cuda.synchronize()
    o_err, lse_err = max_err(o, ref_o), max_err(lse, ref_lse)
    grad_rel = max(
        max_err(part, ref_part) / ref_part.float().abs().max().item()
        for part, ref_part in zip(dqkv.chunk(3, -1), want.chunk(3, -1))
    )
    print(
        f"C9 K4 bf16 {tuple(qkv.shape)}: o max_abs_err {o_err:.3e} (tolerance 5e-3), lse {lse_err:.3e} (1e-3); "
        f"K5: worst third relative {grad_rel:.3e} (tolerance 2e-2)"
    )
    ok = o_err <= 5e-3 and lse_err <= 1e-3 and grad_rel <= 2e-2 and bool(torch.isfinite(dqkv).all())
    expect(ok, f"C9: K4/K5 at N={N} disagree: o {o_err}, lse {lse_err}, grads {grad_rel}")
    leaf = qkv.detach().requires_grad_(True)
    counts = (flash_attention.flash_attention_qkv_forward_lse.launches, flash_attention.flash_attention_qkv_backward.launches)
    flash_attention.flash_attention_qkv(leaf, H).backward(g)
    torch.cuda.synchronize()
    launched = (
        flash_attention.flash_attention_qkv_forward_lse.launches - counts[0],
        flash_attention.flash_attention_qkv_backward.launches - counts[1],
    )
    same = torch.equal(leaf.grad, dqkv)
    print(f"C9: flash_attention_qkv with a gradient at N={N} launched (K4, K5) {launched}; the same gradient bits: {same}")
    expect(launched == (1, 1) and same, f"C9: the training dispatch at N={N} launched {launched}")
    n_bytes = (qkv.numel() + o.numel() + g.numel() + dqkv.numel()) * 2 + lse.numel() * 4
    for label, fn, plain, flops, nb in (
        ("K4", lambda: flash_attention.flash_attention_qkv_forward_lse(qkv, H),
         lambda: flash_attention._qkv_reference_lse(qkv, H), 4 * B * H * N * N * d, (qkv.numel() + o.numel()) * 2),
        ("K5", lambda: flash_attention.flash_attention_qkv_backward(qkv, o, lse, g, H),
         lambda: flash_attention._qkv_backward_reference(qkv, o, lse, g, H), 10 * B * H * N * N * d, n_bytes),
    ):
        b_ms, b_by = bound_ms(nb, flops, PEAK_BF16_FLOPS)
        timing = {}
        timed(timing, "ms", fn)
        timed(timing, "plain_ms", plain, 10)
        print(
            f"C9 {label} N {N} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel, "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, bound {b_ms * 1e3:.2f} us ({b_by})"
        )


def b9_kernels(gen) -> dict[str, dict]:
    """B9 against its plain versions: ``flash_attention_forward`` on the (B, H, N, d) views of the
    DiT-384/6's fused qkv at 64x64 latents and batch 4 (4, 6, 1024, 64), and
    ``flash_attention_packed_forward`` on the chunk(3) views of a (2, 4096, 3*5*128) product; times,
    bounds (4 B H N^2 d operations) and ``scaled_dot_product_attention`` on the same views."""
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch.ops import flash_attention

    dev = torch.device("cuda")
    rows: dict[str, dict] = {}
    cases = (
        ("flash_attention_forward", 195, 4, 1024, 6, 64),
        ("flash_attention_packed_forward", 251, 2, 4096, 5, 128),
    )
    for name, line, B, N, H, d in cases:
        qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        heads = [t.reshape(B, N, H, d).transpose(1, 2) for t in (q, k, v)]
        if name == "flash_attention_forward":
            args = tuple(heads)
            kernel = lambda a=args: flash_attention.flash_attention_forward(*a)  # noqa: E731
            plain = lambda a=args: flash_attention.attention_reference(*a)  # noqa: E731
        else:
            args = (q, k, v, H)
            kernel = lambda a=args: flash_attention.flash_attention_packed_forward(*a)  # noqa: E731
            plain = lambda a=args: flash_attention._packed_reference(*a)  # noqa: E731
        got, want = kernel(), plain()
        library = lambda a=tuple(heads): F.scaled_dot_product_attention(*a)  # noqa: E731
        lib_out = library()
        if name == "flash_attention_packed_forward":
            lib_out = lib_out.transpose(1, 2).reshape(B, N, H * d)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(
            f"B9 {name} bf16 {B}x{H} heads of {d}, N {N} (views of a fused qkv of row stride {q.stride(1)}): "
            f"max_abs_err {err:.3e} (tolerance 5.0e-03, as K2); SDPA vs plain {max_err(lib_out, want):.3e}"
        )
        expect(bool(torch.isfinite(got).all()) and err <= 5e-3, f"B9 {name} disagrees with the plain attention: {err}")
        b_ms, b_by = bound_ms(4 * B * N * H * d * 2, 4 * B * H * N * N * d, PEAK_BF16_FLOPS)
        timing: dict = {}
        timed(timing, "ms", kernel)
        timed(timing, "plain_ms", plain, 10)
        timed(timing, "library_ms", library)
        _attention_route(name, N, d, kernel)
        print(
            f"B9 {name} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel, "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, library {timing['library_ms'] * 1e3:.2f} us "
            f"(scaled_dot_product_attention on the (B, H, N, d) views), bound {b_ms * 1e3:.2f} us ({b_by})"
        )
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": "skrample_tpu_torch/csrc/flash_attention_sm90.cu",
            "replaces": f"skrample_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err,
            "bound_ms": b_ms,
            "bound_by": b_by,
            **timing,
        }
        del qkv, q, k, v, heads, got, want, lib_out
    return rows


def _plain_b13(x, w, b, stats=None, residual=None, repeat_in=1, out_stats=True):
    "B13's plain version behind its wrapper's signature (swapped in for the kernel to hold a path to it)."
    from skrample_tpu_torch.ops import fused_conv

    out, raw = fused_conv.tconv_causal_ref(x, w, b, stats, residual, repeat_in)
    return out, (raw if out_stats else None)


def tconv_kernels(gen) -> dict[str, dict]:
    """B13 against its plain version, bf16, at the 16-frame 512x512 video decode's shapes: the finest
    level's temporal resblock conv with statistics and a residual (1, 16, 262144, 64 -> 64), a frame-repeat
    upsample (1, 8, 65536, 128 -> 128, ``repeat_in=2``) and a mid-level conv with statistics (1, 4, 4096,
    256 -> 256).  Times and bounds; the library time is ``F.conv3d`` (kernel (3, 1, 1), causal by its
    first T outputs) on the normalized (and repeated) input: the conv alone."""
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    rows: dict[str, dict] = {}
    cases = (((1, 16, 262144, 64), 64, "residual", 1), ((1, 8, 65536, 128), 128, "repeat", 2), ((1, 4, 4096, 256), 256, "stats", 1))
    for shape, co, mode, rep in cases:
        B, T, S, C = shape
        k = 3
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        w = torch.randn((k, C, co), generator=gen, device=dev) / (k * C) ** 0.5
        b = 0.1 * torch.randn(co, generator=gen, device=dev)
        stats = res = None
        if mode != "repeat":
            raw_in = fused_conv.channel_stats(x.reshape(B * T, S, C))
            stats = fused_conv.finalize_group_stats(raw_in, 16, S).reshape(B, T, 2, C)
        if mode == "residual":
            res = torch.randn((B, T, S, co), generator=gen, device=dev).to(torch.bfloat16)
        args = (x, w, b, stats, res, rep)
        got, raw = fused_conv.tconv_causal_gn_silu_forward(*args)
        want, want_raw = fused_conv.tconv_causal_ref(*args)
        again, again_raw = fused_conv.tconv_causal_gn_silu_forward(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        rel = err / want.float().abs().max().item()
        raw_rel = _relative(raw, want_raw)
        same = torch.equal(got, again) and torch.equal(raw, again_raw)
        form = {"residual": "GN+SiLU on read, residual, statistics", "repeat": "x2 frame repeat, statistics",
                "stats": "GN+SiLU on read, statistics"}[mode]
        print(
            f"B13 tconv_causal_gn_silu_forward bf16 {shape} -> {co} ({form}): max_abs_err {err:.3e}, relative "
            f"{rel:.3e} (tolerance 1e-2: one bf16 rounding of f32 sums in another order), statistics relative "
            f"{raw_rel:.3e} (1e-2); a second run gives the same bits: {same}"
        )
        ok = bool(torch.isfinite(got).all()) and rel <= 1e-2 and raw_rel <= 1e-2 and same
        expect(ok, f"B13 {shape} {mode} disagrees with the plain version: {rel}, statistics {raw_rel}, same {same}")
        T_out = T * rep
        flops = 2.0 * B * T_out * S * k * C * co
        n_bytes = (x.numel() + k * C * co + got.numel() + (res.numel() if res is not None else 0)) * 2 + co * 4
        n_bytes += raw.numel() * 4 + (stats.numel() * 4 if stats is not None else 0)
        b_ms, b_by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
        xin = x
        if stats is not None:
            xin = fused_conv._normalize_silu(x.float(), stats[:, :, None, 0, :], stats[:, :, None, 1, :]).to(x.dtype)
        if rep > 1:
            xin = xin.repeat_interleave(rep, dim=1)
        x_lib = xin.view(B, T_out, S, 1, C).permute(0, 4, 1, 2, 3)  # channels-last 3-D: no copy
        w_lib = w.to(x.dtype).permute(2, 1, 0)[..., None, None].contiguous(memory_format=torch.channels_last_3d)
        b_lib = b.to(x.dtype)

        def library(a=(x_lib, w_lib, b_lib)):
            return F.conv3d(a[0], a[1], a[2], padding=(k - 1, 0, 0))

        lib_out = library()[:, :, :T_out, :, 0].permute(0, 2, 3, 1)
        lib_rel = max_err(lib_out, want) / want.float().abs().max().item() if res is None else float("nan")
        iters = 5 if flops > 5e10 else 50
        timing: dict = {}
        timed(timing, "ms", lambda a=args: fused_conv.tconv_causal_gn_silu_forward(*a), iters)
        timed(timing, "plain_ms", lambda a=args: _plain_b13(*a), iters)
        timed(timing, "library_ms", library, iters)
        timing["host_us"] = host_us(lambda a=args: fused_conv.tconv_causal_gn_silu_forward(*a))
        plan = fused_conv.tconv_plan(T, S, C, co, k, rep)
        print(
            f"B13 {shape} -> {co} (card time, CUDA-graph replay of {iters}): {timing['ms'] * 1e3:.2f} us kernel "
            f"({flops / timing['ms'] / 1e9:.1f} TFLOP/s, {n_bytes / timing['ms'] / 1e9:.2f} TB/s), "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, library {timing['library_ms'] * 1e3:.2f} us (F.conv3d + bias "
            f"on the normalized input: the conv alone; vs plain {lib_rel:.3e} where there is no residual), bound "
            f"{b_ms * 1e3:.2f} us ({b_by}: {n_bytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP); host "
            f"{timing['host_us']:.1f} us a launch (median of 200); plan ({plan.route}): {plan.block_rows} sites x "
            f"BN {plan.bn} a tile, walks of {plan.walk} frames over {plan.frame_slots} frame slots, "
            f"{plan.b_stages} weight stages, {plan.smem} bytes of shared memory"
        )
        if "tconv_causal_gn_silu_forward" not in rows:  # the row keeps the first shape's numbers
            rows["tconv_causal_gn_silu_forward"] = {
                "name": "tconv_causal_gn_silu_forward",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/tconv.cu",
                "replaces": "skrample_tpu/ops/fused_conv.py:448",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                **{k: v for k, v in timing.items() if k != "host_us"},
            }
        del x, w, got, want, again, args, xin, x_lib, res, lib_out
    return rows


def dit384_phase(card: str) -> dict[str, int]:
    """Phase 9: B9 on the serving path.  The DiT's own default width, DiT-384/6 over 6 heads of 64
    (``DiTConfig(dim=384, depth=6, heads=6, attention="flash")``, bf16, random weights), serves 3
    requests of 4x64x64 latents (2 together, then the first alone): exactly 6 B9a launches a forward,
    A alone against A packed, one forward through the kernels against the plain versions."""
    import torch

    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.ops import adaln, flash_attention
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    config = DiTConfig(dim=384, depth=6, heads=6, compute_dtype=torch.bfloat16, attention="flash")
    model = DiT(config, device=dev).load_jax_params(random_param_tree(config, seed=6)).requires_grad_(False)
    per_forward = dict.fromkeys(_wrappers(), 0)
    per_forward.update(flash_attention_forward=config.depth, adaln_forward=2 * config.depth + 1)
    engine = ServingEngine(
        model.as_sampleable(), item_shape=(4, 64, 64), steps=STEPS, dtype=torch.float32, buckets=(1, 2),
        max_delay_ms=50.0, device=dev,
    )
    with engine:
        engine.generate(99).cpu()  # warm-up
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        pair = [engine.submit(s) for s in SEEDS[:2]]
        outs = [f.result().cpu() for f in pair]
        solo = engine.generate(SEEDS[0]).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counters()
        want = {name: n * 2 * STEPS for name, n in per_forward.items()}
        want["fused_step_cuda"] = 2 * STEPS
        print(f"dit384: 3 requests (2 + 1) in {wall * 1e3:.1f} ms; launches {launches}")
        print(f"dit384: attention launches by route: {_attention_routes()}")
        expect(launches == want, f"dit384: launched {launches}, expected {want} (B9a {config.depth} a forward)")
        for o in (*outs, solo):
            expect(tuple(o.shape) == (4, 64, 64) and bool(torch.isfinite(o).all()), "dit384: bad output")
        packing = _relative(solo, outs[0])
        print(f"dit384: A alone vs A packed: relative max err {packing:.3e}, bit-equal {torch.equal(solo, outs[0])} (tolerance 5e-2)")
        expect(packing <= 5e-2, f"dit384: packing changes request A by {packing}")

        # ---- one forward at batch 2 through the kernels, then through the plain versions ----
        x = torch.randn((2, 4, 64, 64), generator=torch.Generator(dev).manual_seed(3), device=dev)
        with torch.inference_mode():
            _reset_counters()
            got = model(x, 500.0)
            counts = _counters()
            with (
                mock.patch.object(flash_attention, "flash_attention_forward", flash_attention.attention_reference),
                mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
            ):
                plain = model(x, 500.0)
        torch.cuda.synchronize()
        vs_plain = _relative(got, plain)
        print(f"dit384: one forward launched {counts}; kernels vs plain versions: relative max err {vs_plain:.3e} (tolerance 5e-2)")
        expect(counts == per_forward and vs_plain <= 5e-2, f"dit384: forward {counts} / {vs_plain}")
        solo_s = []
        for i in range(3):
            t0 = time.perf_counter()
            engine.generate(200 + i).cpu()
            solo_s.append(time.perf_counter() - t0)
        print(f"dit384: request latency, bucket 1: median {statistics.median(solo_s) * 1e3:.2f} ms of 3 ({card})")
    print(f"dit384: phase took {time.perf_counter() - phase_t0:.1f} s")
    return launches


def sdxl_packed_phase(card: str, parts: dict) -> dict[str, int]:
    """Phase 9b: B9b on a served path.  The phase-7 SDXL UNet read at head dim 32 (heads (10, 20, 40): the
    same weights; ``CondUNet._mha`` zero-pads each head to 128 and pre-scales q, the JAX package's recipe
    for its packed kernel) serves one 10-step 1024x1024 request under CFG 5.0: exactly 70 B9b launches a
    CFG forward (every self-attention) and no B10; one CFG forward (both branches) through the kernels
    against the plain versions.  No published CondUNet has such heads: this drives the route, not a model."""
    import dataclasses

    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.sdxl import SDXLStack
    from skrample_tpu_torch.ops import flash_attention, fused_conv, groupnorm
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    unet, contexts, uncond = parts["unet"], parts["contexts"], parts["uncond"]
    config = unet.config
    unet.config = dataclasses.replace(config, heads=tuple(w // 32 for w in config.widths))
    per_forward = dict(parts["per_forward"], flash_attention_pairs_forward=0, flash_attention_packed_forward=70)
    time_ids = SDXLStack.time_ids((1024, 1024), (0, 0), (1024, 1024), device=dev)
    try:
        served = SDXLStack(unet).as_served(time_ids, 5.0, uncond)
        engine = ServingEngine(
            served, item_shape=(4, 128, 128), sampler=structured.DPM(order=2),
            schedule=scheduling.Karras(scheduling.Scaled()), model_transform=models.NoiseModel(), steps=VAE_STEPS,
            dtype=torch.float32, buckets=(1,), conditioned=True, device=dev,
        )
        with engine:
            torch.cuda.synchronize()
            _reset_counters()
            t0 = time.perf_counter()
            out = engine.generate(1, context=contexts[0]).cpu()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counters()
        want = {name: n * VAE_STEPS for name, n in per_forward.items()}
        want["fused_step_cuda"] = VAE_STEPS
        print(f"sdxl head dim 32: one {VAE_STEPS}-step request in {wall * 1e3:.1f} ms ({card}); launches {launches}")
        print(f"sdxl head dim 32: attention launches by route: {_attention_routes()}")
        expect(launches == want, f"sdxl head dim 32: launched {launches}, expected {want}")
        expect(tuple(out.shape) == (4, 128, 128) and bool(torch.isfinite(out).all()), "sdxl head dim 32: bad latent")
        x = torch.randn((1, 4, 128, 128), generator=torch.Generator(dev).manual_seed(12), device=dev)
        args = (
            torch.cat([x, x]),
            torch.tensor([500.0, 500.0], device=dev),
            torch.stack([contexts[0][0], uncond[0]]),
            torch.stack([contexts[0][1], uncond[1]]),
            time_ids.expand(2, 6),
        )
        with torch.inference_mode():
            got = unet(*args)
            with (
                mock.patch.object(groupnorm, "groupnorm_forward", groupnorm.groupnorm_reference),
                mock.patch.object(flash_attention, "flash_attention_packed_forward", flash_attention._packed_reference),
                mock.patch.object(fused_conv, "conv3x3_gn_silu_forward", _plain_b12),
            ):
                plain = unet(*args)
        vs_plain = _relative(got, plain)
        print(
            f"sdxl head dim 32: one CFG forward through the kernels vs the plain versions: both branches relative "
            f"max err {vs_plain:.3e} (tolerance 5e-2, as phase 7)"
        )
        expect(bool(torch.isfinite(got).all()) and vs_plain <= 5e-2, f"sdxl head dim 32: forward differs by {vs_plain}")
    finally:
        unet.config = config
    print(f"sdxl head dim 32: phase took {time.perf_counter() - phase_t0:.1f} s")
    return launches


VIDEO_GROUPS = (
    ("K1 fused_step", ("fused_step_kernel",)),
    ("K2 flash_qkv", ("flash_qkv_sm90_kernel",)),
    ("K3 adaln", ("adaln_kernel",)),
    ("B12 convs", ("conv3x3_sm90_kernel", "conv3x3_f32_kernel", "conv3x3_bf16_kernel", "conv_stats_reduce_kernel")),
    ("B13 tconvs", ("tconv_sm90_kernel", "tconv_kernel", "tconv_stats_reduce_kernel")),
    ("B8 groupnorm", ("gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")),
    ("plain attention (temporal, VAE mid)", ("softmax",)),
    ("cuBLAS products", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
)
VIDEO_FRAMES, VIDEO_LATENT = 4, (16, 4, 64, 64)  # 16 pixel frames at 512x512 after the 4x temporal, 8x spatial decode


def video_phase(card: str) -> dict[str, int]:
    """Phase 10: the video family served to pixels.  VideoDiT-512/8 (4 heads of 128, 16 channels, bf16)
    and the VideoVAE at the repo's benchmark widths (base 64, 4 levels, 2 temporal levels, 2 blocks,
    groups 16, bf16), random weights (standard init + 0.02 N(0, 1) on every leaf, drawn on the card),
    ``ServingEngine(dit.as_sampleable(), (16, 4, 64, 64), postprocess=vae.decode)``: 3 requests of 25
    steps to (3, 16, 512, 512) pixels (2 together, then the first alone)."""
    import dataclasses

    import torch

    from skrample_tpu_torch.models.video_dit import VideoDiT, VideoDiTConfig, video_dit_forward_flops
    from skrample_tpu_torch.models.video_vae import (
        VideoVAE,
        VideoVAEConfig,
        fused_convs_per_decode,
        fused_decode_on,
        video_vae_decode_flops,
    )
    from skrample_tpu_torch.ops import adaln, flash_attention, fused_conv, groupnorm
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(10)
    dit_cfg = VideoDiTConfig(dim=512, depth=8, heads=4, channels=16, compute_dtype=torch.bfloat16, attention="flash")
    dit = VideoDiT(dit_cfg, device=dev, generator=gen)
    dit.reset_parameters(gen, noise=0.02)
    dit.requires_grad_(False)
    vae_cfg = VideoVAEConfig(base=64, levels=4, temporal_levels=2, blocks_per_level=2, groups=16, fused_decode=True)
    vae = VideoVAE(vae_cfg, device=dev, generator=gen)
    vae.reset_parameters(gen, noise=0.02)
    vae.requires_grad_(False)
    unfused_cfg = dataclasses.replace(vae_cfg, fused_decode=False)
    b12_fused, b13 = fused_convs_per_decode(vae_cfg)
    decode_flops = video_vae_decode_flops(vae_cfg, 1, VIDEO_FRAMES, 64, 64)
    print(
        f"video: VideoDiT-512/8 ({sum(p.numel() for p in dit.parameters()) / 1e6:.2f}M parameters) and VideoVAE "
        f"(widths {vae_cfg.widths()}, {sum(p.numel() for p in vae.parameters()) / 1e6:.2f}M parameters), bf16, drawn "
        f"on the card; a fused decode: {b12_fused} fused B12 convs and {b13} B13 tconvs by the tree; "
        f"{decode_flops / 1e12:.2f} TFLOP a decode"
    )
    expect((b12_fused, b13) == (31, 12), f"video: the tree counts {(b12_fused, b13)} fused convs, expected (31, 12)")
    # the decode's bare in_conv and out_conv are bf16 3x3 convs: B12 with its norm off (_conv, ROADMAP C7)
    per_decode = dict.fromkeys(_wrappers(), 0)
    per_decode.update(conv3x3_gn_silu_forward=b12_fused + 2, tconv_causal_gn_silu_forward=b13, groupnorm_forward=1)
    per_forward = dict.fromkeys(_wrappers(), 0)
    per_forward.update(flash_attention_qkv_forward=dit_cfg.depth, adaln_forward=3 * dit_cfg.depth + 1)
    zgen = torch.Generator(dev).manual_seed(11)

    def latents(b: int):
        return torch.randn((b, *VIDEO_LATENT), generator=zgen, device=dev)

    with torch.inference_mode():  # warm-up, then one decode counted
        for b in (1, 2):
            vae.decode(latents(b))
        torch.cuda.synchronize()
        _reset_counters()
        vae.decode(latents(1))
        one = _counters()
    routes = _routes()
    print(f"video: one fused decode launched {one}; B12 and B13 by route {routes}")
    expect(one == per_decode, f"video: one decode launched {one}, expected {per_decode}")
    want_routes = {
        "conv3x3_gn_silu_forward": {"wgmma": b12_fused + 2, "mma_sync": 0, "f32": 0},
        "tconv_causal_gn_silu_forward": {"wgmma": b13, "mma_sync": 0},
    }
    expect(routes == want_routes, f"video: one decode's routes {routes}, expected {want_routes}")

    engine = ServingEngine(
        dit.as_sampleable(), item_shape=VIDEO_LATENT, steps=STEPS, dtype=torch.float32, buckets=(1, 2),
        max_delay_ms=50.0, device=dev, postprocess=vae.decode,
    )
    with engine:
        engine.generate(99).cpu()  # warm-up: both buckets' heuristics
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        t0 = time.perf_counter()
        pair = [engine.submit(s) for s in SEEDS[:2]]
        outs = [f.result() for f in pair]
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs.append(engine.generate(SEEDS[0]))
        torch.cuda.synchronize()
        solo_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        forwards, dispatches = 2 * STEPS, 2
        want = {name: n * forwards + per_decode[name] * dispatches for name, n in per_forward.items()}
        want["fused_step_cuda"] = forwards
        print(f"video: 3 requests (2 + 1) launched {launches}")
        print(f"video: attention launches by route: {_attention_routes()}")
        expect(launches == want, f"video: launched {launches}, expected {want}")
        for o in outs:
            ok = tuple(o.shape) == (3, 16, 512, 512) and bool(torch.isfinite(o).all())
            expect(ok, f"video: bad pixels {tuple(o.shape)}")
        same = torch.equal(outs[2], outs[0])
        print(
            f"video: request A alone vs A packed with B: bit-equal {same} (relative {_relative(outs[2], outs[0]):.3e}); "
            f"a pair {pair_s * 1e3:.1f} ms, A alone {solo_s * 1e3:.1f} ms; peak {peak / 2**30:.2f} GiB ({card})"
        )
        expect(same, "video: packing changes request A's pixels")

        # ---- one forward through the kernels vs the plain versions; one conditioned CFG forward ----
        plain_dit = (
            (flash_attention, "flash_attention_qkv_forward", flash_attention._qkv_reference),
            (adaln, "adaln_forward", adaln.adaln_reference),
        )
        x = latents(1)
        with torch.inference_mode():
            _reset_counters()
            got = dit(x, 500.0)
            counts = _counters()
            with contextlib.ExitStack() as patches:
                for module, name, fn in plain_dit:
                    patches.enter_context(mock.patch.object(module, name, fn))
                plain = dit(x, 500.0)
        vs_plain = _relative(got, plain)
        print(f"video: one forward launched {counts}; kernels vs plain: relative max err {vs_plain:.3e} (tolerance 5e-2)")
        expect(counts == per_forward and vs_plain <= 5e-2, f"video: forward {counts}, {vs_plain}")
        cond_cfg = dataclasses.replace(dit_cfg, context_dim=512)
        cond = VideoDiT(cond_cfg, device=dev, generator=gen)
        cond.reset_parameters(gen, noise=0.02)
        cond.requires_grad_(False)
        text = torch.randn((64, 512), generator=gen, device=dev)
        guided = cond.as_sampleable(text, guidance_scale=5.0)
        ctx = text[None]
        with torch.inference_mode():
            _reset_counters()
            got = guided(x, 500.0, None, None)
            counts = _counters()
            branches = (cond(x, 500.0, ctx), cond(x, 500.0))
            with contextlib.ExitStack() as patches:
                for module, name, fn in plain_dit:
                    patches.enter_context(mock.patch.object(module, name, fn))
                plain = guided(x, 500.0, None, None)
                plain_branches = (cond(x, 500.0, ctx), cond(x, 500.0))
        want_cfg = dict(per_forward, flash_attention_qkv_forward=2 * dit_cfg.depth, adaln_forward=2 * (4 * dit_cfg.depth + 1))
        vs_plain = [_relative(a, b) for a, b in zip(branches, plain_branches)]
        print(
            f"video: one guided forward (context 512, 64 text tokens, CFG 5.0: conditioned then null row) launched "
            f"{counts}; kernels vs plain: conditioned branch {vs_plain[0]:.3e}, null branch {vs_plain[1]:.3e} "
            f"relative max (tolerance 5e-2); the guidance-5 mix {_relative(got, plain):.3e} (it multiplies the "
            f"branches' difference by 5)"
        )
        expect(counts == want_cfg and max(vs_plain) <= 5e-2, f"video: guided forward {counts}, {vs_plain}")
        del cond, guided

        # ---- the decode: fused vs unfused, each through the kernels vs the plain versions ----
        z = latents(1)
        plain_vae = (
            (fused_conv, "conv3x3_gn_silu_forward", _plain_b12),
            (fused_conv, "tconv_causal_gn_silu_forward", _plain_b13),
            (groupnorm, "groupnorm_forward", groupnorm.groupnorm_reference),
        )
        decoded = {}
        with torch.inference_mode():
            for label, cfg in (("fused", vae_cfg), ("unfused", unfused_cfg)):
                vae.config = cfg
                decoded[label] = vae.decode(z)
                with contextlib.ExitStack() as patches:
                    for module, name, fn in plain_vae:
                        patches.enter_context(mock.patch.object(module, name, fn))
                    _reset_counters()
                    decoded[label + " plain"] = vae.decode(z)
                    expect(all(v == 0 for v in _counters().values()), f"video: the plain {label} decode launched kernels")
            vae.config = vae_cfg
        torch.cuda.synchronize()
        fu = _relative_fro(decoded["fused"], decoded["unfused"])
        fp = _relative(decoded["fused"], decoded["fused plain"])
        up = _relative(decoded["unfused"], decoded["unfused plain"])
        print(
            f"video: fused vs unfused decode: {fu:.3e} relative Frobenius, {_relative(decoded['fused'], decoded['unfused']):.3e} "
            f"relative max (tolerance 5e-2 Frobenius: bf16 activations rounded at other points over 45 layers, "
            f"the uncentered against the centered variance); through the kernels vs the plain versions: fused "
            f"{fp:.3e}, unfused {up:.3e} relative max (tolerance 5e-2)"
        )
        expect(fu <= 5e-2 and fp <= 5e-2 and up <= 5e-2, f"video: decodes disagree: {fu}, {fp}, {up}")
        del decoded

        # ---- times: the forward at the benchmark's 16 x 1024 tokens; decodes fused and unfused in turns ----
        x16 = torch.randn((1, 16, 16, 64, 64), generator=zgen, device=dev)
        flops = video_dit_forward_flops(dit_cfg, 1, 16, 64, 64)
        with torch.inference_mode():
            fwd_s = []
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dit(x16, 500.0 + i)
                torch.cuda.synchronize()
                fwd_s.append(time.perf_counter() - t0)
            fwd = statistics.median(fwd_s[1:])
            print(
                f"video: VideoDiT forward at 16 frames x 1024 tokens: median {fwd * 1e3:.2f} ms of 5, "
                f"{flops / fwd / 1e12:.1f} TFLOP/s ({flops / 1e12:.3f} TFLOP; {card})"
            )
            times: dict[str, list[float]] = {"fused": [], "unfused": []}
            for label in ("fused", "unfused", "unfused", "fused") * 2 + ("fused", "unfused"):
                vae.config = vae_cfg if label == "fused" else unfused_cfg
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vae.decode(z)
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
            vae.config = vae_cfg
            med = {label: statistics.median(v) for label, v in times.items()}
            for label, v in times.items():
                print(
                    f"video: {label} decode of 16 frames at 512x512: median {med[label] * 1e3:.2f} ms of 5 "
                    f"({', '.join(f'{t * 1e3:.2f}' for t in v)}); {decode_flops / med[label] / 1e12:.1f} TFLOP/s ({card})"
                )
            fused_wins = med["fused"] < min(times["unfused"])
            print(
                f"video: C10, fused_decode='auto': the fused median {med['fused'] * 1e3:.2f} ms against the unfused "
                f"fastest {min(times['unfused']) * 1e3:.2f} ms: the card picks {'fused' if fused_wins else 'unfused'}; "
                f"'auto' takes {'fused' if fused_decode_on('auto', dev) else 'unfused'} on the card"
            )
            _traced_dispatch(lambda: vae.decode(z), "video fused decode", med["fused"], card, VIDEO_GROUPS)
            vae.config = unfused_cfg
            _traced_dispatch(lambda: vae.decode(z), "video unfused decode", med["unfused"], card, VIDEO_GROUPS)
            vae.config = vae_cfg
        req_s = []
        for i in range(3):
            t0 = time.perf_counter()
            engine.generate(400 + i).cpu()
            req_s.append(time.perf_counter() - t0)
        median_req = statistics.median(req_s)
        print(
            f"video: request latency to pixels, bucket 1: median {median_req * 1e3:.1f} ms of 3 "
            f"({', '.join(f'{t * 1e3:.1f}' for t in req_s)}; {card}); {_clocks()}"
        )
        _traced_dispatch(lambda: engine.generate(500).cpu(), "video dispatch", median_req, card, VIDEO_GROUPS)
    print(f"video: phase took {time.perf_counter() - phase_t0:.1f} s")
    return launches


def b11_kernels(gen) -> dict[str, dict]:
    """B11 against its plain version at the ring's shapes: the ring DiT-512/8 at sp 1 (one hop over
    the whole 1024-token sequence), one hop of a 4-way ring of it (256 keys), DiT-384's heads of 64,
    and FLUX.1-dev's 4096 + 512 joint tokens over a 4-way ring (a ragged 1152-row block); q from a
    fused qkv's first third and k, v from a fused kv, all (B, H, N, d) strided views.  o within 5e-3
    plus one bf16 ulp of the plain value (``_o_bound``: o's typical size here is 0.05-0.1, so the
    phase's 5e-2 would cover a wrong value product), m and l within 1e-3 of their largest value;
    card times of the kernel, the plain version and ``aten._scaled_dot_product_flash_attention`` (o
    and the row logsumexp ``m + log l``: the same function in another form), bounds (4 B H Nq Nk d
    operations).  Then the S-hop fold: B11 over 4 K/V chunks of the DiT's (4, 1024, 1536) qkv, folded with
    ``softmax_merge``, against K2 over the whole sequence, within the same bound.  The row carries
    the first shape."""
    import torch

    from skrample_tpu_torch.ops import flash_attention

    dev = torch.device("cuda")
    rows: dict[str, dict] = {}
    shapes = ((4, 4, 1024, 1024, 128), (4, 4, 256, 256, 128), (4, 6, 1024, 1024, 64), (1, 24, 1152, 1152, 128))
    for B, H, Nq, Nk, d in shapes:
        q = torch.randn((B, Nq, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)[..., : H * d]
        kv = torch.randn((B, Nk, 2 * H * d), generator=gen, device=dev).to(torch.bfloat16)
        q = q.reshape(B, Nq, H, d).transpose(1, 2)
        k, v = (t.reshape(B, Nk, H, d).transpose(1, 2) for t in kv.chunk(2, dim=-1))
        kernel = lambda q=q, k=k, v=v: flash_attention.flash_attention_block_stats(q, k, v)  # noqa: E731
        plain = lambda q=q, k=k, v=v: flash_attention._block_stats_reference(q, k, v)  # noqa: E731
        library = lambda q=q, k=k, v=v: torch.ops.aten._scaled_dot_product_flash_attention(q, k, v)  # noqa: E731
        (o, m, l), (ro, rm, rl) = kernel(), plain()
        lib = library()
        torch.cuda.synchronize()
        err, o_used = max_err(o, ro), _o_bound(o, ro)
        m_err, l_err = _relative(m, rm), _relative(l, rl)
        lse_err = _relative(lib[1], rm + torch.log(rl))
        label = f"B11 flash_attention_block_stats bf16 q ({B}, {H}, {Nq}, {d}) vs {Nk} keys"
        print(
            f"{label}: o max_abs_err {err:.3e} (plain |o| max {ro.float().abs().max().item():.3e}, rms "
            f"{ro.float().square().mean().sqrt().item():.3e}), {o_used:.3f} of its bound 5e-3 + 2**-8 |plain|; "
            f"m {m_err:.3e} and l {l_err:.3e} relative (tolerance 1e-3); library o vs plain "
            f"{max_err(lib[0], ro):.3e}, its logsumexp vs m + log l {lse_err:.3e}"
        )
        ok = bool(torch.isfinite(o).all()) and o_used <= 1 and m_err <= 1e-3 and l_err <= 1e-3
        expect(ok, f"{label} disagrees with its plain version: o {err} ({o_used} of its bound), m {m_err}, l {l_err}")
        n_bytes = (2 * B * H * Nq * d + 2 * B * H * Nk * d) * 2 + 2 * B * H * Nq * 4
        b_ms, b_by = bound_ms(n_bytes, 4 * B * H * Nq * Nk * d, PEAK_BF16_FLOPS)
        timing: dict = {}
        timed(timing, "ms", kernel)
        timed(timing, "plain_ms", plain, 10)
        timed(timing, "library_ms", library)
        print(
            f"{label} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel, "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, library {timing['library_ms'] * 1e3:.2f} us "
            f"(aten._scaled_dot_product_flash_attention), bound {b_ms * 1e3:.2f} us ({b_by})"
        )
        if "flash_attention_block_stats" not in rows:
            rows["flash_attention_block_stats"] = {
                "name": "flash_attention_block_stats",
                "route": "cuda",
                "source": "skrample_tpu_torch/csrc/flash_attention_sm90.cu",
                "replaces": "skrample_tpu/ops/flash_attention.py:891",
                "max_abs_err": err,
                "bound_ms": b_ms,
                "bound_by": b_by,
                **timing,
            }
        del q, kv, k, v, o, m, l, ro, rm, rl, lib

    # ---- the S-hop fold: 4 K/V chunks of the DiT qkv through B11 + softmax_merge vs K2 ----
    B, N, H, d, S = 4, 1024, 4, 128, 4
    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t.reshape(B, N, H, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    peak = torch.full(q.shape[:-1], -math.inf, dtype=torch.float32, device=dev)
    total = torch.zeros(q.shape[:-1], dtype=torch.float32, device=dev)
    for k_blk, v_blk in zip(k.chunk(S, dim=2), v.chunk(S, dim=2)):
        acc, peak, total = flash_attention.softmax_merge(
            (acc, peak, total), flash_attention.flash_attention_block_stats(q, k_blk, v_blk)
        )
    folded = (acc / total[..., None]).to(torch.bfloat16).transpose(1, 2).reshape(B, N, H * d)
    whole = flash_attention.flash_attention_qkv_forward(qkv, H)
    torch.cuda.synchronize()
    err, o_used = max_err(folded, whole), _o_bound(folded, whole)
    print(
        f"B11 {S}-hop fold of the DiT qkv {tuple(qkv.shape)} with softmax_merge vs K2: max_abs_err {err:.3e} "
        f"(K2 |o| max {whole.float().abs().max().item():.3e}), {o_used:.3f} of its bound 5e-3 + 2**-8 |K2|"
    )
    expect(bool(torch.isfinite(folded).all()) and o_used <= 1, f"B11 {S}-hop fold differs from K2 by {err}")
    return rows


def _o_bound(got, want) -> float:
    """The largest ``|got - want| / (5e-3 + 2**-8 |want|)``: at most 1 when every output is within
    5e-3 plus one bf16 ulp of ``want`` (two attentions in bf16 that normalise before and after
    the value product round apart by an ulp where outputs are large)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (5e-3 + 2**-8 * want.abs())).max().item()


SP_GROUPS = (
    ("K1 fused_step", ("fused_step_kernel",)),
    ("K3 adaln", ("adaln_kernel",)),
    ("B11 block_stats", ("flash_block_stats_sm90_kernel",)),
    ("B9 strided", ("flash_strided_sm90_kernel",)),
    ("cuBLAS products", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
    ("NCCL", ("nccl",)),
)


def sp_phase(card: str) -> dict[str, int]:
    """Phase 11: sequence-parallel serving on a one-rank NCCL group.  ``make_mesh(dp=1, sp=1)`` over
    ``init_process_group("nccl", world_size=1)`` (a ``FileStore`` in a temp dir, ``device_id`` the
    card; no other backend), then phase 3's DiT-512/8 with ``attention="ring"`` (B11 a block, 8 a
    forward) and phase 9's DiT-384/6 with ``attention="ulysses"`` (B9a a block, 6 a forward), each on
    the same random tree as its flash DiT, through ``ServingEngine`` (25-step DPM++2M over
    FlowShift(Linear), buckets (1, 2)): 3 requests of 4x64x64 (2 together, then the first alone) with
    exact launch counts, A alone == A packed bit for bit, the request against the flash DiT's
    (5e-2 relative), one forward through the plain versions (no launch, 5e-2), latency medians with
    their spread, and one traced request's launches by group."""
    import torch
    import torch.distributed as dist

    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0)
    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(str(Path(tmp) / "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh(dp=1, sp=1)
            print(f"sp: NCCL group of 1 rank on {dev}, mesh {mesh}")
            models = (
                ("ring DiT-512/8", {"dim": 512, "depth": DEPTH, "heads": 4}, "ring", 0, "flash_attention_block_stats"),
                ("ulysses DiT-384/6", {"dim": 384, "depth": 6, "heads": 6}, "ulysses", 6, "flash_attention_forward"),
            )
            for label, shape, attention, seed, kernel in models:
                config = DiTConfig(**shape, compute_dtype=torch.bfloat16, attention=attention)
                tree = random_param_tree(config, seed)
                model = DiT(config, mesh=mesh, device=dev).load_jax_params(tree).requires_grad_(False)
                flash_config = DiTConfig(**shape, compute_dtype=torch.bfloat16, attention="flash")
                flash = DiT(flash_config, device=dev).load_jax_params(tree).requires_grad_(False)
                per_forward = dict.fromkeys(_wrappers(), 0)
                per_forward.update({kernel: config.depth, "adaln_forward": 2 * config.depth + 1})
                launches = _sp_serve(label, model, flash, per_forward, card)
                for name, count in launches.items():
                    total[name] += count
                del model, flash
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    print(f"sp: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


def _sp_serve(label: str, model, flash, per_forward: dict[str, int], card: str) -> dict[str, int]:
    "Phase 11 for one model; returns the main path's launches (the 3 requests)."
    import torch

    from skrample_tpu_torch.ops import adaln, flash_attention
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda", 0)
    item = (4, 64, 64)

    def engine_of(m) -> ServingEngine:
        return ServingEngine(
            m.as_sampleable(), item_shape=item, steps=STEPS, dtype=torch.float32, buckets=(1, 2),
            max_delay_ms=50.0, device=dev,
        )

    with engine_of(flash) as reference:
        want = reference.generate(SEEDS[0]).cpu()
    with engine_of(model) as engine:
        engine.generate(99).cpu()  # warm-up
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        pair = [engine.submit(s) for s in SEEDS[:2]]
        outs = [f.result().cpu() for f in pair]
        solo = engine.generate(SEEDS[0]).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counters()
        want_counts = {name: n * 2 * STEPS for name, n in per_forward.items()}
        want_counts["fused_step_cuda"] = 2 * STEPS
        print(f"sp {label}: 3 requests (2 + 1) in {wall * 1e3:.1f} ms; launches {launches}")
        print(f"sp {label}: attention launches by route: {_attention_routes()}")
        expect(launches == want_counts, f"sp {label}: launched {launches}, expected {want_counts}")
        for o in (*outs, solo):
            expect(tuple(o.shape) == item and bool(torch.isfinite(o).all()), f"sp {label}: bad output")
        bit_equal = torch.equal(solo, outs[0])
        print(f"sp {label}: A alone vs A packed: bit-equal {bit_equal}, relative max err {_relative(solo, outs[0]):.3e}")
        expect(bit_equal, f"sp {label}: request A alone differs from A packed")
        vs_flash = _relative(solo, want)
        print(f"sp {label}: request A vs the flash DiT's: relative max err {vs_flash:.3e} (tolerance 5e-2)")
        expect(vs_flash <= 5e-2, f"sp {label}: the request differs from the flash DiT's by {vs_flash}")

        # ---- one forward at batch 2 through the kernels, then through the plain versions ----
        x = torch.randn((2, *item), generator=torch.Generator(dev).manual_seed(3), device=dev)
        with torch.inference_mode():
            _reset_counters()
            got = model(x, 500.0)
            counts = _counters()
            with (
                mock.patch.object(
                    flash_attention, "flash_attention_block_stats", flash_attention._block_stats_reference
                ),
                mock.patch.object(flash_attention, "flash_attention_forward", flash_attention.attention_reference),
                mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
            ):
                _reset_counters()
                plain = model(x, 500.0)
                plain_counts = _counters()
        torch.cuda.synchronize()
        vs_plain = _relative(got, plain)
        print(f"sp {label}: one forward launched {counts}; kernels vs plain versions: relative max err {vs_plain:.3e} (tolerance 5e-2)")
        expect(counts == per_forward, f"sp {label}: a forward launched {counts}, expected {per_forward}")
        expect(not any(plain_counts.values()), f"sp {label}: the plain forward launched {plain_counts}")
        expect(bool(torch.isfinite(plain).all()) and vs_plain <= 5e-2, f"sp {label}: kernels vs plain {vs_plain}")

        # ---- latency at the engine's default 2 ms window, and one traced request ----
        engine.max_delay_s = 2e-3
        solo_s = []
        for i in range(5):
            t0 = time.perf_counter()
            engine.generate(200 + i).cpu()
            solo_s.append(time.perf_counter() - t0)
        median = statistics.median(solo_s)
        print(
            f"sp {label}: request latency, bucket 1: median {median * 1e3:.2f} ms of 5 "
            f"(min {min(solo_s) * 1e3:.2f}, max {max(solo_s) * 1e3:.2f}; {card})"
        )
        traced = _traced_dispatch(lambda: engine.generate(300).cpu(), f"sp {label}", median, card, SP_GROUPS)
        print(f"sp {label}: {sum(traced.values())} kernel launches a request ({card})")
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
        serving, dit_outputs = slice_phase(device["card"])
        train = training_phase(device["card"])
        dit_int8 = int8_dit_phase(device["card"], dit_outputs)
        flux_bf16, flux_int8 = flux_phase(device["card"])
        sdxl, sdxl_parts = sdxl_phase(device["card"])
        vae = vae_phase(device["card"], sdxl_parts)
        dit384 = dit384_phase(device["card"])
        packed = sdxl_packed_phase(device["card"], sdxl_parts)
        video = video_phase(device["card"])
        sp = sp_phase(device["card"])
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1

    # each row's launches: its counts summed over every path's main-path run
    runs = (serving, train, dit_int8, flux_bf16, flux_int8, sdxl, vae, dit384, packed, video, sp)
    for name, row in rows.items():
        row["launches"] = sum(run[name] for run in runs)
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
