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
   together, then the first alone) through the decode that
   ``fused_decode="auto"`` takes on the card, the fused one; exact
   launches (B12 31, all on its f32 route, and B8 1 per decode on top of
   the UNet's), finite pixels, A alone == A packed bit for bit, the fused
   decode against the unfused one and against the plain versions (1e-3
   relative Frobenius), median fused and unfused decode times (C10: which
   one ``"auto"`` should take), one traced fused decode by kernel group,
   and one ``encode_image`` at 1024x1024;
9. DiT-384/6 (heads of 64: B9a 6 a forward) served, and (9b) the SDXL UNet
   read at head dim 32 (B9b);
10. the video family to pixels: VideoDiT-512/8 and the VideoVAE (B12, B13);
11. sequence-parallel serving on a one-rank NCCL group
    (``make_mesh(dp=1, sp=1)``): the phase-3 DiT with ``attention="ring"``
    (B11 once a block) and the phase-9 DiT with ``attention="ulysses"``
    (B9a once a block) through ``ServingEngine``: exact launches, A alone ==
    A packed bit for bit, each request against its flash DiT's, one forward
    against the plain versions, latency medians and one traced request.
    Phase 2 holds B11 to its plain version at four ring-hop shapes;
12. the library's generation surface: ``GenerationPipeline`` over phase 3's
    DiT-512/8 (25-step DPM++2M / FlowShift(Linear)): deterministic, bit for
    bit the ``ServingEngine`` request of the same seed; stochasticity 0.3
    with in-loop key noise (``CompiledDenoiser.run(key=)``: the same key
    twice bit for bit, the kernels against the plain versions, the host
    cost of one threefry draw); Brownian structured noise (``stack_noise``
    timed), img2img at strength 0.6 and CFG 3.0; latency medians; the
    functional ``RKUltra(order=4)`` loop over the same DiT (K2/K3 a model
    call, no K1; against the plain versions); ``SDXLStack.pipeline`` over
    phase 7's UNet at 1024x1024 with CFG 5.0, bit for bit phase 7's request
    A; and the noise generators on the card against the CPU (threefry bits
    and uniforms exact, normals 1e-5, Pyramid and Colored 1e-4 relative),
    with exact launches on every counted request;
13. the diffusers scheduler wrapper, driven as a ``DiffusionPipeline`` drives
    it (``set_timesteps(n, device=, mu=)``, ``init_noise_sigma``,
    ``scale_model_input``, the model with CFG, ``step``):
    ``SkrampleWrapperScheduler.from_diffusers_config`` of SDXL base's scheduler
    config with DPM(order=2) over phase 7's UNet (1024x1024, CFG 5.0, 25
    steps) at f32, then bf16 and f16 latents: one K1 launch a step, each run
    bit for bit the same loop through the wrapper's plain chain; FLUX.1-dev's
    scheduler config with UniPC(order=3) over phase 3's DiT-512/8 (``mu`` from
    the token count): K1 against the plain chain and a ``state_dict`` resume,
    both bit for bit, the result against ``GenerationPipeline``'s, latency of
    both in turns, the host time of a step of each, a traced wrapper request;
    ``RKUltraWrapperScheduler(order=4)``; ``rk_sample_loop(RKUltra(order=4))``
    and ``AdaptivePipeline(RKMoire(order=3))`` over the DiT: exact K1 launches
    (one a mixing stage and a step, or a trial), K1 against its plain version
    bit for bit, the kernels against the plain versions and the eager RK loop.
    Phase 2 holds K1's f16 and f64 instances and its f32-weight mode to the
    plain chain bit for bit;
14. A2's second half over phase 3's DiT-512/8: ``ServingEngine(graph=True)``
    answers phase 3's 6 requests as CUDA-graph replays, bit for bit phase 3's
    eager results with its launches a replayed dispatch, latency and images
    per second in turns with the eager engine, a traced request of each;
    ``GenerationPipeline(graph=True)`` with stochasticity 0.3 bit for bit
    phase 12's key-drawn request; ``ContinuousServingEngine(slots=4)``, eager
    and graphed, 1 and 5 ticks a dispatch (4 requests admitted in one tick ==
    phase 3's bucket of 4, 8 staggered arrivals == each alone, K1 == its
    plain version, one device-weights K1 launch a tick step), occupancy and
    latency under the staggered arrivals against the batch engine; and
    ``training.GraphedTrainStep`` (AdamW ``capturable=True``, EMA from a device
    step) == the eager ``train_step`` after 5 steps, bit for bit, with phase
    4's launches a replay, the median of 20 steps and a traced step of each.
    Phase 2 holds K1's device-weights mode (per-item rows of a table on the
    card, f32, bf16, f16 and f64 latents, the scalar path) to its plain
    version bit for bit, with its card time beside the by-value K1's.
15. the rest of training (``AdamW8bit``, LoRA, the loader, kill and resume, the VAE losses) and Flux at
    head dims 64 and 96;
16. SD3 at SD3.5-large's widths (MMDiT 38 x 2432, bf16; CLIP-L, CLIP-G and the T5-XXL encoder; the SD3 VAE,
    f32), random weights drawn on the card: prompts tokenized over synthetic vocabularies and encoded by the
    three towers, served to 1024x1024 pixels by ``ServingEngine(stack.as_served(4.5, uncond),
    conditioned=True, postprocess=stack.decode)`` at 10 Euler steps over FlowShift(Linear) (3 requests: 2
    together, then the first alone, bit for bit its packed twin), exact launches (K3 152, B7 76 and B10 38 a
    forward, K1 a step, B12 31 and B8 1 a decode), latency and a traced request; one forward against the
    plain versions; the int8 model (B6 303 a forward, cosine > 0.99); SD3.5-medium's widths (dual attention:
    B10 37 a forward) against the plain versions; and ROADMAP C6: the one-pass dense product against the two
    passes, bit for bit, at every dense shape of phases 3, 6, 7 and 16.  Phase 2 holds B10 and B7 (identity
    tables) to their plain versions at SD3.5-large's joint shape (2, 4429, 38 x 64).
17. A8's rest (run before phase 16, which frees phase 7's UNet): (a) a ControlNet at
    controlnet-canny-sdxl-1.0's widths through ``diffusers_controlnet`` (a synthetic full-width state dict),
    bf16, drawn random on the card, over phase 7's UNet: ``SDXLStack(unet, vae).pipeline(controlnet=,
    control_image=)`` at 1024x1024, CFG 5.0, 25 steps (scale 0 bit for bit the request without one; exact
    launches, B8 67, B10 104, B12 60 and K1 1 a step; pixels; the median of 3, a traced request; one step
    against the plain versions); (b) the UNet's int8 scopes ``"deep"`` (B6 432 a CFG forward) and ``"all"``
    (512), cosine > 0.99, their card times beside bf16's; (c) ``FluxStack`` at FLUX.1-dev's widths (CLIP-L,
    the T5-XXL encoder at 512 tokens, the Flux VAE f32) from text ids to 1024x1024 pixels, served at 10
    Euler steps over FlowShift(Linear, dynamic_shift(4096)) (A alone == A packed, ``stack.pipeline`` ==
    the served request, bit for bit); (d) C6 at their dense shapes.  Phase 2 adds B12 at the ControlNet
    ladder's five stride-1 shapes, and phase 12d redraws one key's normals on each side and under each
    ATen CPU capability.
18. after phase 16, every earlier model freed: (a) the text-to-image trainer
    (``train_text_to_image``) at SD3.5-medium's widths in the native wiring
    with a CLIP-L-width encoder: 20 joint steps of batch 4 (64x64 latents),
    exact launches (K3 110, K6 109, B7 61 and B10 37 a step), the loss
    falling, one step against the plain versions, a traced step; (b) on a
    one-rank NCCL group, ``make_mesh(dp=1, sp=1)``: both engines (eager and
    graphed) and the pipeline over phase 3's DiT-512/8, the
    sequence-parallel VideoDiT at phase 10's widths and one ``--dp 1`` step
    of each trainer, each bit for bit its mesh-less twin; the
    SD3.5-medium-width MMDiT with ``"ring"`` (B11) and ``"ulysses"`` (B9)
    against ``"flash"``.
19. tensor parallelism and FSDP: (a) on a one-rank NCCL group,
    ``make_mesh(dp=1, sp=1, extra_axes={"tp": 1})``: ``ServingEngine(mesh=)``
    over DiT-512/8, a FLUX.1-dev request (1024x1024, 4 steps) and one int8
    forward, the SD3.5-medium-width MMDiT's ring at tp 1 x sp 1, one CFG
    forward of SDXL base's UNet, one ``train_text_to_image --tp 1`` step and
    three ``GraphedTrainStep(mesh=)`` steps (``--dp 1 --graph``), each bit
    for bit its mesh-less twin with the same launches; (b) two processes on
    the card over gloo at tp 2: DiT-512/8's bf16 forward within 5e-2 relative
    of its unsharded twin and FLUX.1-dev's int8 forward bit for bit the
    unsharded one, with each rank's peak memory; then two processes on the
    card over gloo: 3 DiT-512/8 steps at ``--dp 2 --fsdp``
    against ``--dp 2`` (AdamW and ``--opt8``) bit for bit, each rank's
    parameter bytes, and phase 15c's ``--dp 2 --fsdp --opt8``
    kill-and-resume against the uninterrupted run, bit for bit.
20. pipeline stages, the sequence-parallel gradient, experts, utilities:
    (a) two processes on the card over gloo at pp 2: DiT-512/8's
    ``apply_pipelined`` at microbatch 1 and 2 against ``apply``, one training
    step through the stage hops against the unpipelined step (loss and the
    rank's gradients), the SD3.5-medium-width MMDiT (uniform blocks, depth 4)
    pipelined against ``apply``; then at sp 2 one ring and one ulysses
    DiT-512/8 training step against flash; (b) on a one-rank NCCL group the
    ring and ulysses steps against flash; (c) the MoE FFN at
    ``scripts/bench_moe.py``'s widths, capacity dispatch at full capacity
    against dense, and ``utils.trace`` around a DiT-512/8 request, its trace
    file read back.

Every read of the launch counters holds each K2, K4, K5, B9, B10 and B11
launch to the route of the Hopper kernels (wgmma: ``csrc/flash_attention_sm90.cu``
and ``csrc/flash_attention_bwd.cu``), and each path phase prints its attention
launches by route; the device phase requires the sixteen Hopper attention
instantiations and the ten of B12's f32 route to build without spills or
injected warpgroup fences.

The second-to-last line is a JSON object listing the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
``skrample_tpu_torch`` package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
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
PEAK_TF32_FLOPS = 494.7e12
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
SD3_STEPS = 10  # phase 16 cuts SD3's default 28 steps to keep the phase within its time: the family is what it adds
SD3_GUIDANCE = 4.5  # the SD3.5-large pipeline's default guidance
SD3_TOKENS = 4096 + 77 + 256  # the joint sequence: 1024x1024 image tokens at patch 2, CLIP's 77, T5's 256


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
    f32_convs = {label: st for label, st in stats.items() if label.startswith("conv3x3_f32_")}
    expect(len(f32_convs) == 10, f"expected 10 f32 conv instantiations in the build log: {sorted(f32_convs)}")
    for label, st in {**attention, **f32_convs}.items():
        expect(st.get("spills") == 0 and st["fences"] == 0, f"{label}: {st.get('spills')} bytes spilled, {st['fences']} fences")
    return {"name": name, "count": count, "card": card}


def _sm90_label(mangled: str) -> str | None:
    """A Hopper instantiation's readable name from its mangled one: the convs' <WN, MT> (a consumer
    warpgroup's N width and M tiles), the attention's <type, head dim, lse> (the forward body's K2/K4, B9/B10
    and B11 kernels, K5's dq and dkv kernels); None for other kernels."""
    import re

    conv = re.search(r"(conv3x3_f32|conv3x3|tconv)_sm90_kernelILi(\d+)ELi(\d+)E", mangled)
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
    latent = (4, 4, 64, 64)
    # the kernel rounds each product and sum in the plain chain's order: every case must be bit-exact
    cases = [
        ("slice f32 rows 1 K 4", torch.float32, w_slice, latent),
        ("f32 rows 3 K 7", torch.float32, np.random.default_rng(0).standard_normal((3, 7)), latent),
        ("bf16 rows 1 K 4", torch.bfloat16, w_slice, latent),
        ("video f32 rows 1 K 4", torch.float32, w_slice, (16, 4, 64, 64)),
    ]
    for label, dtype, w, shape in cases:
        basis = [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(w.shape[1])]
        got = fused.fused_step_cuda(w, basis)
        ref = fused.fused_step(w, basis)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        print(
            f"K1 fused_step_cuda {label} {shape}: max_abs_err {err:.3e} (tolerance 0: bit-exact); "
            f"plan (vec, threads, blocks) {fused.step_plan(basis[0].numel(), dtype)}"
        )
        ok = bool(torch.isfinite(got).all()) and torch.equal(got, ref)
        expect(ok, f"K1 {label} is not bit-exact against the plain chain: max_abs_err {err}")
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
        elif label.startswith("video"):
            video_ms, _ = cuda_ms(lambda w=w, basis=basis: fused.fused_step_cuda(w, basis))
            n_bytes = (len(basis) + w.shape[0]) * basis[0].numel() * basis[0].element_size()
            print(f"K1 fused_step_cuda {label}: {video_ms * 1e3:.2f} us (card time, CUDA-graph replay), bound "
                  f"{n_bytes / HBM_BYTES_PER_S * 1e6:.2f} us (bytes)")
    # the least a K1 launch costs on this card: one 8-element latent (two f32 vectors), in graph replay
    tiny = [torch.randn(8, generator=gen, device=dev) for _ in range(4)]
    floor_ms, _ = cuda_ms(lambda: fused.fused_step_cuda(w_slice, tiny))
    print(f"K1 fused_step_cuda launch floor, f32 rows 1 K 4 at n = 8: {floor_ms * 1e3:.2f} us (card time, CUDA-graph "
          f"replay), against the slice's {rows['fused_step_cuda']['ms'] * 1e3:.2f} us and its bound "
          f"{rows['fused_step_cuda']['bound_ms'] * 1e3:.2f} us")
    # the diffusers wrapper's instances: f16 and f64 latents, and weights rounded to f32 at bf16 and f16
    wrapper_cases = [
        ("f16 rows 1 K 4", torch.float16, w_slice, None),
        ("f64 rows 1 K 4", torch.float64, w_slice, None),
        ("f64 rows 3 K 17", torch.float64, np.random.default_rng(1).standard_normal((3, 17)), None),
        ("bf16 f32-weights rows 3 K 7", torch.bfloat16, np.random.default_rng(2).standard_normal((3, 7)), torch.float32),
        ("f16 f32-weights rows 1 K 4", torch.float16, w_slice, torch.float32),
    ]
    for label, dtype, w, weight_dtype in wrapper_cases:
        basis = [torch.randn(latent, generator=gen, device=dev, dtype=torch.float64).to(dtype) for _ in range(w.shape[1])]
        got = fused.fused_step_cuda(w, basis, weight_dtype=weight_dtype)
        ref = fused.fused_step(w, basis, weight_dtype=weight_dtype)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        expect(bool(torch.isfinite(got).all()) and torch.equal(got, ref), f"K1 {label} is not bit-exact: {err}")
        k_ms, _ = cuda_ms(lambda w=w, basis=basis, wd=weight_dtype: fused.fused_step_cuda(w, basis, weight_dtype=wd))
        n_bytes = (len(basis) + w.shape[0]) * basis[0].numel() * basis[0].element_size()
        print(
            f"K1 fused_step_cuda {label} {latent}: max_abs_err {err:.3e} (tolerance 0: bit-exact); {k_ms * 1e3:.2f} us "
            f"(card time, CUDA-graph replay; f32 rows 1 K 4: {rows['fused_step_cuda']['ms'] * 1e3:.2f} us), bound "
            f"{n_bytes / HBM_BYTES_PER_S * 1e6:.2f} us (bytes); instance {fused.step_instance(*w.shape, dtype)}"
        )

    # K1's device-weights mode (the tick's and jitted_step_indexed's): per-item rows [0, 7, 24, 3] of the 25-step
    # table on the card, the table in f32 whatever the latent's dtype (rounded to it first), a whole-latent item
    # (an int row and a 0-d index), and items of 105 elements (not a multiple of any vector: the scalar path)
    table_1x4 = torch.from_numpy(compiled.weights[:, :1, :4].copy()).to(dev, torch.float32)
    table_3x7 = torch.from_numpy(np.random.default_rng(3).standard_normal((STEPS, 3, 7))).to(dev, torch.float32)
    index = torch.tensor([0, 7, 24, 3], dtype=torch.int32, device=dev)
    device_cases = [
        (f"{name} rows {table.shape[1]} K {table.shape[2]}", dtype, table, shape)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16), ("f16", torch.float16), ("f64", torch.float64))
        for table, shape in ((table_1x4, latent), (table_3x7, latent))
    ] + [("bf16 rows 3 K 7, items of 105 (scalar path)", torch.bfloat16, table_3x7, (4, 3, 5, 7))]
    for label, dtype, table, shape in device_cases:
        basis = [torch.randn(shape, generator=gen, device=dev, dtype=torch.float64).to(dtype) for _ in range(table.shape[2])]
        errs = []
        for idx in (index, 10, torch.tensor(10, dtype=torch.int32, device=dev)):
            got = fused.fused_step_indexed_cuda(table, idx, basis)
            ref = fused.fused_step_indexed(table, idx, basis)
            torch.cuda.synchronize()
            errs.append(max_err(got, ref))
            expect(bool(torch.isfinite(got).all()) and torch.equal(got, ref), f"K1 device weights {label}: not bit-exact, {errs[-1]}")
        line = f"K1 device weights {label} {shape}, per-item rows {index.tolist()} and one whole-latent item: max_abs_err {max(errs):.3e} (tolerance 0: bit-exact)"
        if label == "f32 rows 1 K 4":
            dev_ms, dev_eager = cuda_ms(lambda t=table, b=basis: fused.fused_step_indexed_cuda(t, index, b))
            line += (
                f"; {dev_ms * 1e3:.2f} us (card time, CUDA-graph replay; {dev_eager * 1e3:.2f} us a call eagerly) against "
                f"the by-value K1's {rows['fused_step_cuda']['ms'] * 1e3:.2f} us at the same shape"
            )
        print(line)

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
    rows.update(sd3_kernels(gen))
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
        alone = adaln.adaln_backward(x[2:3].contiguous(), gx[2:3].contiguous(), scale[2:3])
        torch.cuda.synchronize()
        alone_same = all(torch.equal(a[0], b[2]) for a, b in zip(alone, got))
        chunk_rows = adaln.backward_rows(D)
        print(f"K6 adaln_backward {dtype}: item 2 alone == item 2 in the batch of {B}, bit for bit: {alone_same}; "
              f"token rows a block {chunk_rows}, chunks an item {adaln.backward_chunks(N, chunk_rows)}")
        expect(alone_same, "K6: an item alone differs from the same item in the batch")
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

    # ---- B7 at head dim 64 (its instance, two rows a warp) and 96 (the run-time-d body): Flux-like bf16 qkv,
    # 24 heads, the image stream's rows of the joint tables, in place (ROADMAP C13) ----
    for dh, route, key in ((64, "d64", "rope_qk_norm_forward d64"), (96, "run-time d", "rope_qk_norm_forward d96")):
        angles = torch.rand((L + N_IMG, dh // 2), generator=gen, device=dev) * 64
        c, s_ = torch.cos(angles)[L:], torch.sin(angles)[L:]
        gq = 1 + 0.1 * torch.randn(dh, generator=gen, device=dev)
        gk = 1 + 0.1 * torch.randn(dh, generator=gen, device=dev)
        qkv = (torch.randn((1, N_IMG, 3 * H * dh), generator=gen, device=dev) * 2).to(torch.bfloat16)
        want = rope.rope_qk_norm_reference(qkv, gq, gk, c, s_, H)
        before = rope.rope_qk_norm_forward.routes[route]
        inplace = rope.rope_qk_norm_forward(qkv.clone(), gq, gk, c, s_, H, in_place=True)
        fresh = rope.rope_qk_norm_forward(qkv, gq, gk, c, s_, H)
        torch.cuda.synchronize()
        ulps = max(_ulps_bf16(fresh, want), _ulps_bf16(inplace, want))
        v_same = torch.equal(fresh[..., 2 * H * dh :], qkv[..., 2 * H * dh :]) and torch.equal(inplace, fresh)
        err = max(max_err(fresh, want), max_err(inplace, want))
        scale = want.float().abs().max().item()
        on_route = rope.rope_qk_norm_forward.routes[route] - before
        # the sum of squares in another order moves rsqrt by an f32 ulp, which a rotation's cancellation can
        # carry into a few bf16 ulps of a small output: the tolerance is one bf16 ulp of the largest output
        print(
            f"B7 rope_qk_norm_forward head dim {dh} ({route}) bf16 {tuple(qkv.shape)}: max_abs_err {err:.3e} "
            f"(tolerance {2**-7 * scale:.3e}: 2**-7 of the largest output), at most {ulps:g} bf16 ulp of an output; "
            f"v third bit-equal and in place == fresh: {v_same}; launches on the route {on_route}"
        )
        expect(err <= 2**-7 * scale and v_same and on_route == 2, f"B7 at head dim {dh}: {err}, v {v_same}, route {on_route}")
        qk_bytes = N_IMG * 2 * H * dh * 2
        b_ms, b_by = bound_ms(2 * qk_bytes + 2 * c.numel() * 4 + 2 * dh * 4, 8 * N_IMG * 2 * H * dh, PEAK_F32_FLOPS)
        args = (qkv, gq, gk, c, s_, H)
        timing = {}
        timed(timing, "ms", lambda args=args: rope.rope_qk_norm_forward(*args, in_place=True))
        timed(timing, "plain_ms", lambda args=args: rope.rope_qk_norm_reference(*args))
        print(
            f"B7 head dim {dh} (card time, CUDA-graph replay): {timing['ms'] * 1e3:.2f} us kernel in place, "
            f"{timing['plain_ms'] * 1e3:.2f} us plain, bound {b_ms * 1e3:.2f} us ({b_by})"
        )
        rows[key] = {
            "name": key,
            "route": "cuda",
            "source": "skrample_tpu_torch/csrc/rope.cu",
            "replaces": "skrample_tpu/ops/rope.py:94",
            "max_abs_err": err,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            **timing,
        }
        del qkv, want, inplace, fresh

    # ---- the d = 64 flash route of a Flux (C13): B10's body on the chunk(3) views of a joint qkv, 48 heads of 64 ----
    N = L + N_IMG
    qkv = torch.randn((1, N, 3 * 48 * 64), generator=gen, device=dev).to(torch.bfloat16)
    views = qkv.chunk(3, dim=-1)
    before = flash_attention.flash_attention_pairs_forward.launches
    got = flash_attention.flash_attention_pairs(*views, 48)
    ref = flash_attention._packed_reference(*views, 48)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    launched = flash_attention.flash_attention_pairs_forward.launches - before
    flash_ms, _ = cuda_ms(lambda: flash_attention.flash_attention_pairs(*views, 48))
    plain_ms, _ = cuda_ms(lambda: flash_attention._packed_reference(*views, 48))
    print(
        f"Flux d = 64 flash route (flash_attention_pairs on chunk(3) views of {tuple(qkv.shape)}, 48 heads): max_abs_err "
        f"{err:.3e} against the plain attention (tolerance 5.0e-03), {launched} B10 launch; {flash_ms * 1e3:.2f} us "
        f"kernel, {plain_ms * 1e3:.2f} us plain (card time, CUDA-graph replay)"
    )
    expect(bool(torch.isfinite(got).all()) and err <= 5e-3 and launched == 1, f"the d = 64 Flux route: {err}, {launched}")
    del qkv, views, got, ref

    # ---- K2 at the Flux shape: bf16 qkv (1, 4608, 9216), 24 heads of 128 ----
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
    residual, at four of the SDXL VAE's fused-decode shapes (the f32 route: 3xTF32 wgmma); bf16 with the norm,
    the affine, a residual and the statistics at (1, 256, 256, 512); the video decode's finest level
    (16 frames of 512x512, 64 -> 64: the norm without affine, a residual, the statistics) and its bare
    64 -> 3 out_conv; bare, statistics off, the SDXL UNet's convs at (2, 64, 64, 640), (2, 128, 128,
    320) and (2, 32, 32, 1280) (the C7 route), and the ControlNet ladder's five stride-1 convs, (2, 1024,
    1024, 3) -> 16 on the mma.sync route, then 16 -> 16, (2, 512, 512, 32) -> 32, (2, 256, 256, 96) -> 96
    and (2, 128, 128, 256) -> 320; every other bf16 shape on the wgmma route.  Times, bounds, the
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
        # the ControlNet conditioning ladder's stride-1 convs at CFG batch 2 (controlnet-canny-sdxl-1.0's
        # (16, 32, 96, 256) ladder over a 1024x1024 control image): C = 3 on the mma.sync route, then Co 16
        ((2, 1024, 1024, 3), 16, bf16, False, False, False, False),
        ((2, 1024, 1024, 16), 16, bf16, False, False, False, False),
        ((2, 512, 512, 32), 32, bf16, False, False, False, False),
        ((2, 256, 256, 96), 96, bf16, False, False, False, False),
        ((2, 128, 128, 256), 320, bf16, False, False, False, False),
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
        if dtype == torch.float32:
            # two bounds of the f32 conv: its three TF32 products on the tensor cores, one FFMA product on the
            # CUDA cores; the share is read against the smaller, so that no route can read over 100%
            tf32_ms, ffma_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3, flops / PEAK_F32_FLOPS * 1e3
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = min(tf32_ms, ffma_ms)
            b_ms, b_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
            print(
                f"B12 f32 {shape} -> {co}: bounds 3xTF32 {tf32_ms * 1e3:.2f} us (3 x {flops / 1e9:.1f} GFLOP at "
                f"{PEAK_TF32_FLOPS / 1e12:.1f} TFLOP/s), FFMA {ffma_ms * 1e3:.2f} us (at {PEAK_F32_FLOPS / 1e12:.0f} "
                f"TFLOP/s), bytes {bytes_ms * 1e3:.2f} us; the row's bound: {b_ms * 1e3:.2f} us ({b_by})"
            )
        else:
            b_ms, b_by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
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
            if plan.route in ("wgmma", "f32") else ""
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
        for tally in ("routes", "modes"):  # launches by route (attention, B12, B13) or by mode (K1)
            if hasattr(fn, tally):
                setattr(fn, tally, dict.fromkeys(getattr(fn, tally), 0))


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


def card_time(prof) -> tuple[dict[str, float], dict[str, int], float]:
    """The card's time in a torch.profiler trace: ``(ms by kernel name, launches by kernel name, busy ms)``.

    Busy is the union of the kernels' spans on the card.  Each instant of it counts once, for the kernel
    that started first among those running then, so the kernels' times add up to it.  A programmatic
    dependent launch (K1, K6's reduce) is traced from its launch, while the kernel before it still runs:
    a sum of the spans would count that overlap twice.  A user annotation on the card's timeline
    (AdamW's "Optimizer.step") spans kernels counted already and is left out."""
    import torch

    spans = sorted(
        (e.time_range.start, e.time_range.end, e.key)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.time_range.end > e.time_range.start
    )
    ms: dict[str, float] = {}
    launches: dict[str, int] = {}
    covered = -math.inf
    for start, end, name in spans:
        ms[name] = ms.get(name, 0.0) + max(0.0, end - max(start, covered)) / 1e3
        launches[name] = launches.get(name, 0) + 1
        covered = max(covered, end)
    return ms, launches, sum(ms.values())


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
    kernel_ms, kernel_launches, busy = card_time(prof)
    busy /= traced
    for name, ms in kernel_ms.items():
        label = _train_group(name)
        card_ms[label] = card_ms.get(label, 0.0) + ms / traced
        card_launches[label] = card_launches.get(label, 0) + kernel_launches[name]
        if label == "other":
            others[name[:100]] = others.get(name[:100], 0.0) + ms / traced
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
    run, label: str, median_s: float, card: str, groups: tuple = FLUX_GROUPS, share: str | None = None,
    record: dict | None = None,
) -> dict[str, int]:
    """The card's time by kernel group over one traced dispatch, and its busy share of the median untraced
    one; ``share`` names a group whose share of the busy time gets a line of its own; ``record`` (a dict)
    receives the busy ms and the ms by kernel name."""
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
    kernel_ms, kernel_counts, busy = card_time(prof)
    if record is not None:
        record.update(busy_ms=busy, kernel_ms=kernel_ms)
    for name, ms in kernel_ms.items():
        group = _group(name, groups)
        card_ms[group] = card_ms.get(group, 0.0) + ms
        card_launches[group] = card_launches.get(group, 0) + kernel_counts[name]
        names[name[:90]] = names.get(name[:90], 0.0) + ms
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


B12_KERNELS = (  # B12's kernels by name (csrc/fused_conv.cu): bf16 wgmma, f32 3xTF32 with its weight split, mma.sync
    "conv3x3_sm90_kernel", "conv3x3_f32_sm90_kernel", "tf32_split_kernel", "conv3x3_bf16_kernel",
    "conv_stats_reduce_kernel",
)
B8_KERNELS = ("gn_stats_kernel", "gn_apply_kernel")  # csrc/groupnorm.cu: statistics with their finalize, apply
SDXL_GROUPS = (
    ("B12 convs", B12_KERNELS),
    ("K1 fused_step", ("fused_step_kernel",)),
    ("B8 groupnorm", B8_KERNELS),
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
    parts = {"unet": unet, "contexts": contexts, "uncond": uncond, "per_forward": per_forward, "request_a": outs[2]}
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
    ("B12 convs", B12_KERNELS),
    ("B8 groupnorm", B8_KERNELS),
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
    from skrample_tpu_torch.models.vae import VAE, fused_convs_per_decode, fused_decode_on, vae_decode_flops
    from skrample_tpu_torch.ops import fused_conv, groupnorm
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    config = vae_config(SDXL_VAE_CONFIG)  # fused_decode "auto": the fused decode on the card (C10)
    expect(fused_decode_on(config.fused_decode, dev), f"vae: fused_decode {config.fused_decode!r} unfused on the card")
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
        one_routes = _routes()["conv3x3_gn_silu_forward"]
    want_one = dict.fromkeys(_wrappers(), 0)
    want_one.update(conv3x3_gn_silu_forward=31, groupnorm_forward=1)  # B8: the mid attention's norm
    print(f"vae: one decode call launched {one}; B12 by route {one_routes}")
    expect(one == want_one, f"vae: one decode launched {one}, expected {want_one}")
    expect(one_routes == {"wgmma": 0, "mma_sync": 0, "f32": 31}, f"vae: one decode's B12 routes {one_routes}")

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
        f32_launches = _routes()["conv3x3_gn_silu_forward"]["f32"]
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
    print(f"vae: f32 B12 launches on the main path {f32_launches}, all on the f32 route (3xTF32 wgmma)")
    want_f32 = per_decode * dispatches
    expect(f32_launches == want_f32, f"vae: {f32_launches} f32 B12 launches, expected {want_f32}")
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
        print(
            f"vae: C10, fused_decode='auto': the fused median {med['fused'] * 1e3:.1f} ms against the unfused "
            f"median {med['unfused'] * 1e3:.1f} ms: the card picks "
            f"{'fused' if med['fused'] < med['unfused'] else 'unfused'}; "
            f"'auto' takes {'fused' if fused_decode_on('auto', dev) else 'unfused'} on the card"
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
    ("B12 convs", B12_KERNELS),
    ("B13 tconvs", ("tconv_sm90_kernel", "tconv_kernel", "tconv_stats_reduce_kernel")),
    ("B8 groupnorm", B8_KERNELS),
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


PIPE_SHAPE = (1, 4, 64, 64)  # one DiT-512/8 request's latent, with its batch axis
PIPE_REPEATS = 5  # requests per latency median


def _pipeline_request(
    label: str, run, want: dict[str, int], total: dict[str, int], phase: str = "pipeline"
) -> object:
    """One main-path request of phase 12 (or 14): the counters set to 0 just before it, read just after, held
    to ``want`` exactly and added to ``total``; the output must be finite."""
    import torch

    torch.cuda.synchronize()
    _reset_counters()
    out = run()
    torch.cuda.synchronize()
    launches = _counters()
    want = {name: want.get(name, 0) for name in launches}
    print(f"{phase} {label}: launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}")
    expect(launches == want, f"{phase} {label}: launched {launches}, expected {want}")
    expect(bool(torch.isfinite(out).all()), f"{phase} {label}: non-finite output")
    for name, count in launches.items():
        total[name] += count
    return out


def _median_ms(run, repeats: int = PIPE_REPEATS) -> tuple[float, list[float]]:
    "The median of ``repeats`` host-clock request latencies, each ending in its result's copy to the host."
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run().cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


NOISE_REDRAWS = (200, 50)  # phase 12d's redraws of one key's normals: on the card, on the CPU


def _cpu_capability_normals(key_seed: int) -> dict[str, bool]:
    """Phase 12d's probe of the CPU side: the same key's normals drawn in a fresh process under each ATen CPU
    capability this host offers, against this process's draw, bit for bit (a CPU kernel whose rounding
    depends on the host's vector width would move the CPU's normals from host to host)."""
    import torch

    from skrample_tpu_torch import prng

    want = prng.normal(prng.PRNGKey(key_seed), PIPE_SHAPE, device="cpu")
    code = (
        "import sys, torch; sys.path.insert(0, sys.argv[1]); from skrample_tpu_torch import prng; "
        f"torch.save(prng.normal(prng.PRNGKey({key_seed}), {PIPE_SHAPE}, device='cpu'), sys.argv[2]); "
        "print(torch.backends.cpu.get_cpu_capability())"
    )
    same = {}
    with tempfile.TemporaryDirectory() as tmp:
        for cap in ("default", "avx2", "avx512"):
            path = os.path.join(tmp, f"{cap}.pt")
            run = subprocess.run(
                [sys.executable, "-c", code, str(ROOT), path], env={**os.environ, "ATEN_CPU_CAPABILITY": cap},
                capture_output=True, text=True, timeout=120,
            )
            expect(run.returncode == 0, f"pipeline noise 12d: the {cap} probe failed: {run.stderr[-400:]}")
            same[f"{cap} (ran {run.stdout.strip()})"] = torch.equal(torch.load(path), want)
    return same


def _noise_on_card_vs_cpu() -> None:
    """Phase 12d: the noise generators drawn on the card against the same seed drawn on the CPU, at
    (1, 4, 64, 64) and steps 0, 12 and 24 of 25.  First the same key's normals redrawn on each side and held to
    that side's first draw, and the CPU's draw under each ATen CPU capability: a card-vs-CPU difference then
    says which side moved (one earlier run found them 7.451e-5 apart, every other 7.153e-7)."""
    import torch

    from skrample_tpu_torch import noise, prng
    from skrample_tpu_torch.common import Step

    dev = torch.device("cuda")
    key = prng.PRNGKey(2024)
    card_first = prng.normal(key, PIPE_SHAPE, device=dev).cpu()
    cpu_first = prng.normal(key, PIPE_SHAPE, device="cpu")
    card_moved = [
        i for i in range(NOISE_REDRAWS[0]) if not torch.equal(prng.normal(key, PIPE_SHAPE, device=dev).cpu(), card_first)
    ]
    cpu_moved = [
        i for i in range(NOISE_REDRAWS[1]) if not torch.equal(prng.normal(key, PIPE_SHAPE, device="cpu"), cpu_first)
    ]
    capabilities = _cpu_capability_normals(2024)
    print(
        f"pipeline noise 12d: one key's normals redrawn {NOISE_REDRAWS[0]} times on the card and {NOISE_REDRAWS[1]} "
        f"on the CPU (torch {torch.__version__}, CPU capability "
        f"{torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads): draws that differ from their "
        f"side's first, card {card_moved}, CPU {cpu_moved}; the CPU's draw under each capability in a fresh process "
        f"equal to this one: {capabilities}"
    )
    expect(not card_moved and not cpu_moved, f"pipeline noise 12d: redraws moved: card {card_moved}, CPU {cpu_moved}")
    expect(all(capabilities.values()), f"pipeline noise 12d: the CPU's normals follow its capability: {capabilities}")
    bits_equal = torch.equal(prng.random_bits(key, PIPE_SHAPE, device=dev).cpu(), prng.random_bits(key, PIPE_SHAPE, device="cpu"))
    uniforms_equal = all(
        torch.equal(prng.uniform(key, PIPE_SHAPE, dtype, device=dev).cpu(), prng.uniform(key, PIPE_SHAPE, dtype, device="cpu"))
        for dtype in (torch.float32, torch.bfloat16, torch.float16)
    )
    normal_err = max_err(card_first, cpu_first)
    print(
        f"pipeline noise: prng bits equal {bits_equal}, uniforms (f32, bf16, f16) equal {uniforms_equal} (tolerance 0); "
        f"normals max abs err {normal_err:.3e} (tolerance 1e-5: CUDA's erfinv vs the CPU's)"
    )
    expect(bits_equal and uniforms_equal, "pipeline noise: threefry bits or uniforms differ on the card")
    expect(normal_err <= 1e-5, f"pipeline noise: normals differ by {normal_err}")
    for name in ("Random", "Offset", "Pyramid", "Colored", "Brownian"):
        cls = getattr(noise, name)
        on_card, on_cpu = cls.from_inputs(PIPE_SHAPE, 5, device=dev), cls.from_inputs(PIPE_SHAPE, 5, device="cpu")
        errs = []
        for n in (0, 12, 24):
            got = on_card.generate(n, Step.from_int(n, STEPS)).cpu()
            want = on_cpu.generate(n, Step.from_int(n, STEPS))
            expect(tuple(got.shape) == PIPE_SHAPE and bool(torch.isfinite(got).all()), f"pipeline noise: bad {name}")
            errs.append(_relative(got, want) if name in ("Pyramid", "Colored") else max_err(got, want))
        if name in ("Pyramid", "Colored"):
            how = "relative max err", 1e-4, "cuBLAS products" if name == "Pyramid" else "cuFFT vs pocketfft"
        else:
            how = "max abs err", 1e-5, "CUDA's erfinv vs the CPU's"
        print(
            f"pipeline noise: {name} on the card vs the CPU, steps 0/12/24: {how[0]} "
            f"{', '.join(f'{e:.3e}' for e in errs)} (tolerance {how[1]:g}: {how[2]})"
        )
        expect(max(errs) <= how[1], f"pipeline noise: {name} differs on the card by {max(errs)}")


def pipeline_phase(card: str, parts: dict) -> dict[str, int]:
    """Phase 12: the library's generation surface on the card.  (a) ``GenerationPipeline`` over phase
    3's DiT-512/8 (bf16, the same random tree), 25-step DPM++2M over FlowShift(Linear) with FlowModel:
    deterministic, equal bit for bit to ``ServingEngine``'s request of the same seed; with stochasticity
    0.3 and in-loop key noise (``CompiledDenoiser.run(key=)``), the same key twice bit for bit and the
    kernels against the plain versions; with Brownian structured noise (``stack_noise`` timed), img2img
    at strength 0.6 (entering at step 10) and CFG 3.0 through a second DiT as ``uncond_model_fn``;
    latency medians, and the host cost of one in-loop threefry normal.  (b) ``RKUltra(order=4)`` (the
    functional RK loop) over the same DiT, K2/K3 as many times as its model calls, no K1.  (c)
    ``SDXLStack.pipeline`` over phase 7's UNet, 1024x1024, CFG 5.0: phase 7's request A.  (d) the
    noise generators on the card against the CPU.  Returns the main path's launches (the counted
    requests of a-c)."""
    import torch

    from skrample_tpu_torch import prng, scheduling
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.models.sdxl import SDXLStack
    from skrample_tpu_torch.noise import Brownian, BrownianProps, stack_noise
    from skrample_tpu_torch.ops import adaln, flash_attention, fused
    from skrample_tpu_torch.pipeline import GenerationPipeline
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.sampling.rk_solvers import RKUltra
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    config = DiTConfig(
        dim=512, depth=DEPTH, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash"
    )
    model = DiT(config, device=dev).load_jax_params(random_param_tree(config, seed=0)).requires_grad_(False)
    uncond = DiT(config, device=dev).load_jax_params(random_param_tree(config, seed=1)).requires_grad_(False)
    schedule, transform = scheduling.FlowShift(scheduling.Linear()), models.FlowModel()

    def pipeline(stochasticity: float = 0.0, **kwargs) -> GenerationPipeline:
        return GenerationPipeline(
            model.as_sampleable(), structured.DPM(order=2, stochasticity=stochasticity), schedule, transform, STEPS,
            PIPE_SHAPE, device=dev, **kwargs,
        )

    def per_request(steps: int, forwards: int = 1) -> dict[str, int]:
        return {
            "fused_step_cuda": steps,
            "flash_attention_qkv_forward": DEPTH * steps * forwards,
            "adaln_forward": (2 * DEPTH + 1) * steps * forwards,
        }

    plain_kernels = (
        mock.patch("skrample_tpu_torch.ops.loop.fused_step_cuda", lambda w, basis: fused.fused_step(w, basis)),
        mock.patch.object(flash_attention, "flash_attention_qkv_forward", flash_attention._qkv_reference),
        mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
    )

    # ---- a.1: deterministic DPM++2M, against ServingEngine's request of the same seed ----
    det = pipeline()
    det.generate(99).cpu()  # warm-up: library handles, allocator
    got = _pipeline_request("DiT deterministic", lambda: det.generate(SEEDS[0]), per_request(STEPS), total).cpu()
    with ServingEngine(
        model.as_sampleable(), PIPE_SHAPE[1:], structured.DPM(order=2), schedule, transform, STEPS, buckets=(1,),
        device=dev,
    ) as engine:
        served = engine.generate(SEEDS[0]).cpu()
    bit_equal = torch.equal(got[0], served)
    print(
        f"pipeline DiT deterministic: GenerationPipeline.generate({SEEDS[0]}) vs ServingEngine.generate({SEEDS[0]}): "
        f"bit-equal {bit_equal}, max abs err {max_err(got[0], served):.3e} (tolerance 0)"
    )
    expect(bit_equal, "pipeline: the deterministic DiT pipeline differs from ServingEngine's request")

    # ---- a.2: stochasticity 0.3, per-step noise drawn in the loop from the request key ----
    sde = pipeline(0.3)
    sde.generate(98).cpu()
    noisy = _pipeline_request("DiT stochastic", lambda: sde.generate(SEEDS[1]), per_request(STEPS), total).cpu()
    parts["pipeline_stochastic"] = noisy  # phase 14 replays this request as one CUDA graph
    again = sde.generate(SEEDS[1]).cpu()
    expect(torch.equal(noisy, again), "pipeline: the same key gave another image")
    expect(_relative(noisy, got) > 1e-2, "pipeline: stochasticity 0.3 did not move the image")
    _reset_counters()
    with plain_kernels[0], plain_kernels[1], plain_kernels[2]:
        plain = sde.generate(SEEDS[1]).cpu()
    expect(not any(_counters().values()), f"pipeline: the plain run launched kernels: {_counters()}")
    vs_plain = _relative(noisy, plain)
    print(
        f"pipeline DiT stochastic (in-loop key noise): same key twice bit-equal True; kernels vs plain versions "
        f"relative max err {vs_plain:.3e} (tolerance 5e-2, bf16)"
    )
    expect(bool(torch.isfinite(plain).all()) and vs_plain <= 5e-2, f"pipeline: kernels vs plain {vs_plain}")
    key = prng.PRNGKey(SEEDS[1])
    draw_us = host_us(lambda: prng.normal(key, PIPE_SHAPE, torch.float32, dev))
    print(
        f"pipeline: one in-loop threefry normal of {PIPE_SHAPE} (a step's noise): {draw_us:.1f} us of host time "
        f"(median of 200 eager draws; {card})"
    )

    # ---- a.3: Brownian structured noise, img2img at strength 0.6, CFG 3.0 ----
    gen = Brownian.from_inputs(PIPE_SHAPE, SEEDS[2], BrownianProps(), device=dev)
    stack_noise(gen, 2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    noises = stack_noise(gen, STEPS)
    torch.cuda.synchronize()
    stack_ms = (time.perf_counter() - t0) * 1e3
    print(
        f"pipeline: stack_noise(Brownian(depth {gen.depth}), {STEPS}) on the card: {stack_ms:.1f} ms "
        f"(host clock, synchronized; {tuple(noises.shape)}; {card})"
    )
    brown = pipeline(0.3, noise_generator=gen)
    expect(torch.equal(brown._noises, noises), "pipeline: the cached Brownian noise differs from stack_noise's")
    _pipeline_request("DiT Brownian", lambda: brown.generate(SEEDS[2]), per_request(STEPS), total)
    start = min(round(STEPS * (1 - 0.6)), STEPS - 1)
    expect(start == 10, f"pipeline: img2img at 0.6 enters at {start}")
    initial = got.to(dev)
    _pipeline_request(
        "DiT Brownian img2img 0.6", lambda: brown.generate(SEEDS[2], initial, 0.6), per_request(STEPS - start), total
    )
    cfg = pipeline(0.3, uncond_model_fn=uncond.as_sampleable(), guidance_scale=3.0)
    cfg.generate(97).cpu()
    _pipeline_request("DiT CFG 3.0", lambda: cfg.generate(SEEDS[3]), per_request(STEPS, 2), total)

    # ---- a.4: latency medians, one configuration after another (the engine first); one traced request ----
    with ServingEngine(
        model.as_sampleable(), PIPE_SHAPE[1:], structured.DPM(order=2), schedule, transform, STEPS, buckets=(1,),
        device=dev,
    ) as engine:
        medians = {
            "ServingEngine, deterministic": _median_ms(lambda: engine.generate(302)),
            "deterministic": _median_ms(lambda: det.generate(303)),
            "stochastic in-loop key noise": _median_ms(lambda: sde.generate(300)),
            "Brownian structured noise (precomputed)": _median_ms(lambda: brown.generate(301)),
        }
    for label, (median, every) in medians.items():
        print(
            f"pipeline: request latency, {label}: median {median:.2f} ms of {PIPE_REPEATS} "
            f"({', '.join(f'{v:.2f}' for v in every)}; {card})"
        )
    sde_ms = medians["stochastic in-loop key noise"][0]
    _traced_dispatch(lambda: sde.generate(304).cpu(), "pipeline stochastic", sde_ms / 1e3, card, FLUX_GROUPS)

    # ---- b: the functional RK loop (RKUltra order 4) over the same DiT ----
    sampler = RKUltra(order=4)
    rk_steps = sampler.adjust_steps(STEPS)
    rk_key = prng.PRNGKey(SEEDS[4])

    def rng(step):
        "Counter-based draws on the card: the initial latent, then one a step."
        index = 0 if step is None else 1 + round(step.time_from * rk_steps)
        return prng.normal(prng.fold_in(rk_key, index), PIPE_SHAPE, torch.float32, dev)

    calls: list[int] = []
    sampler.sample_model(  # the model calls step_tableau makes (terminal stages it skips excluded), on the host
        torch.zeros(1, dtype=torch.float64), lambda x, t, s, a: calls.append(1) or x * 0.5, transform, schedule,
        rk_steps,
    )
    stages = len(sampler.tableau().stages)
    print(
        f"pipeline RKUltra(order=4): {stages}-stage tableau, adjust_steps({STEPS}) = {rk_steps} steps, "
        f"{len(calls)} model calls ({stages * rk_steps} stages less {stages * rk_steps - len(calls)} skipped)"
    )

    def rk_run():
        with torch.inference_mode():
            return sampler.generate_model(model.as_sampleable(), transform, schedule, rng, rk_steps)

    rk_want = dict(per_request(len(calls)), fused_step_cuda=0)
    rk_out = _pipeline_request("RKUltra(order=4)", rk_run, rk_want, total).cpu()
    with plain_kernels[1], plain_kernels[2]:
        rk_plain = rk_run().cpu()
    rk_vs_plain = _relative(rk_out, rk_plain)
    print(f"pipeline RKUltra(order=4): kernels vs plain versions relative max err {rk_vs_plain:.3e} (tolerance 5e-2)")
    expect(bool(torch.isfinite(rk_plain).all()) and rk_vs_plain <= 5e-2, f"pipeline: RK kernels vs plain {rk_vs_plain}")
    del model, uncond, det, sde, brown, cfg
    torch.cuda.empty_cache()

    # ---- c: SDXLStack.pipeline over phase 7's UNet, phase 7's request A ----
    context, pooled = parts["contexts"][0]
    sdxl = SDXLStack(parts["unet"]).pipeline(
        context, pooled, height=1024, width=1024, steps=SDXL_STEPS, guidance_scale=5.0, uncond=parts["uncond"],
        device=dev,
    )
    expect(sdxl.latent_shape == (1, 4, 128, 128), f"pipeline: SDXL latent {sdxl.latent_shape}")
    sdxl.generate(500).cpu()  # warm-up
    want = {name: count * SDXL_STEPS for name, count in parts["per_forward"].items()}
    want["fused_step_cuda"] = SDXL_STEPS
    t0 = time.perf_counter()
    latent = _pipeline_request("SDXL", lambda: sdxl.generate(1), want, total).cpu()[0]
    sdxl_ms = (time.perf_counter() - t0) * 1e3
    request_a = parts["request_a"]
    sdxl_equal = torch.equal(latent, request_a)
    print(
        f"pipeline SDXL: SDXLStack.pipeline(1024x1024, CFG 5.0).generate(1) vs phase 7's ServingEngine request A "
        f"(seed 1, the same prompt features): bit-equal {sdxl_equal}, relative max err "
        f"{_relative(latent, request_a):.3e}; one request {sdxl_ms:.1f} ms ({card})"
    )
    expect(sdxl_equal, "pipeline: SDXLStack.pipeline's latent differs from phase 7's request A")

    # ---- d: the noise generators on the card against the CPU ----
    _noise_on_card_vs_cpu()
    print(f"pipeline: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


# the scheduler configs a DiffusionPipeline hands the wrapper (the fields it reads), written in code:
# stabilityai/stable-diffusion-xl-base-1.0 scheduler/scheduler_config.json
SDXL_SCHEDULER_CONFIG = {
    "_class_name": "EulerDiscreteScheduler",
    "beta_end": 0.012,
    "beta_schedule": "scaled_linear",
    "beta_start": 0.00085,
    "clip_sample": False,
    "num_train_timesteps": 1000,
    "prediction_type": "epsilon",
    "steps_offset": 1,
    "timestep_spacing": "leading",
    "trained_betas": None,
    "use_karras_sigmas": False,
}
# black-forest-labs/FLUX.1-dev scheduler/scheduler_config.json
FLUX_SCHEDULER_CONFIG = {
    "_class_name": "FlowMatchEulerDiscreteScheduler",
    "base_image_seq_len": 256,
    "base_shift": 0.5,
    "max_image_seq_len": 4096,
    "max_shift": 1.15,
    "num_train_timesteps": 1000,
    "shift": 3.0,
    "use_dynamic_shifting": True,
}


def _calculate_shift(seq_len: int, config: dict) -> float:
    "diffusers' ``calculate_shift``: the dynamic FlowShift's ``mu``, linear in the latent's token count."
    m = (config["max_shift"] - config["base_shift"]) / (config["max_image_seq_len"] - config["base_image_seq_len"])
    return seq_len * m + config["base_shift"] - m * config["base_image_seq_len"]


def _scheduler_loop(scheduler, model, latents, first: int = 0, last: int | None = None):
    """The loop a ``DiffusionPipeline`` runs once ``set_timesteps`` has run, over its timesteps ``first`` to
    ``last``: ``init_noise_sigma`` (when starting at the first), ``scale_model_input``, the model
    (classifier-free guidance inside its closure, over the doubled batch), ``step``."""
    if first == 0:
        latents = latents * scheduler.init_noise_sigma
    for t in scheduler.timesteps[first:last]:
        prediction = model(scheduler.scale_model_input(latents, t), t, None, None)
        latents = scheduler.step(prediction, t, latents, return_dict=False)[0]
    return latents


def _rk_stage_counts(sampler, schedule, steps: int) -> tuple[int, int, int]:
    """``rk_sample_loop``'s structure: (stages, stages that mix earlier derivatives, steps on the fused path:
    all but a final step with a stage at t = 0 or sigma = 0)."""
    from skrample_tpu_torch.common import Step

    tableau = sampler.tableau()
    last = Step.from_int(steps - 1, steps)
    points = schedule.ipoints([last[0] + st.c * (last[1] - last[0]) for st in tableau.stages])
    fused_steps = steps - any(abs(p.timestep) < 1e-8 or abs(p.sigma) < 1e-8 for p in points)
    return len(tableau.stages), sum(bool(st.a) for st in tableau.stages), fused_steps


def diffusers_phase(card: str, parts: dict) -> dict[str, int]:
    """Phase 13: the diffusers scheduler wrapper and the RK and adaptive loops on the card.  (a)
    ``SkrampleWrapperScheduler.from_diffusers_config`` of SDXL base's scheduler config with DPM(order=2) over
    phase 7's UNet, 1024x1024, CFG 5.0, 25 steps, ``compute_scale=torch.float32``, driven as a
    ``DiffusionPipeline`` drives it: one K1 launch a step, bit for bit the same loop with K1 swapped for the
    wrapper's plain chain; (b) the same at ``compute_scale=None`` with bf16, then f16 latents; (c) FLUX.1-dev's
    scheduler config with UniPC(order=3) over phase 3's DiT-512/8, ``mu`` from the latent's token count: a
    ``state_dict`` resume bit for bit, the result against ``GenerationPipeline``'s, latency medians of the two
    and a traced wrapper request; (d) ``RKUltraWrapperScheduler(order=4)`` over the DiT; (e)
    ``rk_sample_loop(RKUltra(order=4))`` and ``AdaptivePipeline(RKMoire(order=3))`` over the DiT: exact K1
    launches, against K1's plain version bit for bit, against the plain versions and the eager loop.  Returns
    the main path's launches (the counted requests)."""
    import torch

    from skrample_tpu_torch import prng, scheduling
    from skrample_tpu_torch.diffusers import RKUltraWrapperScheduler, SkrampleWrapperScheduler
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.models.sdxl import SDXLStack
    from skrample_tpu_torch.ops import adaln, flash_attention, fused
    from skrample_tpu_torch.ops.loop import rk_sample_loop
    from skrample_tpu_torch.pipeline import AdaptivePipeline, GenerationPipeline
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.sampling.rk_solvers import RKMoire, RKUltra

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)

    def plain_k1(w, basis, weight_dtype=None):
        return fused.fused_step(w, basis, weight_dtype)

    wrapper_plain = mock.patch("skrample_tpu_torch.diffusers.fused_step_cuda", plain_k1)
    loop_plain = mock.patch("skrample_tpu_torch.ops.loop.fused_step_cuda", plain_k1)

    # ---- a, b: SDXL base's scheduler config over phase 7's UNet, CFG 5.0 ----
    context, pooled = parts["contexts"][0]
    sdxl_model = SDXLStack(parts["unet"]).model_fn(
        context, pooled, SDXLStack.time_ids((1024, 1024), (0, 0), (1024, 1024), device=dev), 5.0, parts["uncond"]
    )
    x_sdxl = torch.randn((1, 4, 128, 128), generator=torch.Generator(dev).manual_seed(41), device=dev)
    sdxl_want = {name: count * SDXL_STEPS for name, count in parts["per_forward"].items()}
    sdxl_want["fused_step_cuda"] = SDXL_STEPS

    def sdxl_request(dtype: torch.dtype, compute_scale):
        wrapper = SkrampleWrapperScheduler.from_diffusers_config(
            SDXL_SCHEDULER_CONFIG, sampler=structured.DPM, sampler_props={"order": 2}, compute_scale=compute_scale
        )
        wrapper.set_timesteps(SDXL_STEPS, device=dev)
        with torch.inference_mode():
            return _scheduler_loop(wrapper, sdxl_model, x_sdxl.to(dtype))

    probe = SkrampleWrapperScheduler.from_diffusers_config(
        SDXL_SCHEDULER_CONFIG, sampler=structured.DPM, sampler_props={"order": 2}
    )
    print(
        f"diffusers: SDXL base scheduler config -> {probe.sampler}, {probe.schedule}, {probe.model}; "
        f"config {dict(probe.config)['_class_name']}, num_train_timesteps {probe.config.num_train_timesteps}"
    )
    expect(type(probe.schedule).__name__ == "Scaled" and type(probe.model).__name__ == "NoiseModel",
           f"diffusers: SDXL config parsed to {probe.schedule}, {probe.model}")
    for label, dtype, compute_scale in (
        ("f32 latents, compute_scale=float32", torch.float32, torch.float32),
        ("bf16 latents, compute_scale=None", torch.bfloat16, None),
        ("f16 latents, compute_scale=None", torch.float16, None),
    ):
        t0 = time.perf_counter()
        got = _pipeline_request(f"diffusers SDXL {label}", lambda: sdxl_request(dtype, compute_scale), sdxl_want,
                                total)
        request_ms = (time.perf_counter() - t0) * 1e3
        with wrapper_plain:
            plain = sdxl_request(dtype, compute_scale)
        torch.cuda.synchronize()
        equal = torch.equal(got, plain)
        print(
            f"diffusers SDXL {label}: DPM(order=2), 25 steps, CFG 5.0 at 1024x1024: {request_ms:.1f} ms; K1 on its "
            f"{got.dtype} instance ({SDXL_STEPS} launches) vs the wrapper's plain chain: bit-equal {equal}, max abs err "
            f"{max_err(got, plain):.3e} (tolerance 0); {card}"
        )
        expect(got.dtype == dtype and equal, f"diffusers SDXL {label}: K1 differs from the plain chain")

    # ---- c: FLUX.1-dev's scheduler config over phase 3's DiT-512/8 (bf16 latents, f32 steps) ----
    config = DiTConfig(
        dim=512, depth=DEPTH, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash"
    )
    model = DiT(config, device=dev).load_jax_params(random_param_tree(config, seed=0)).requires_grad_(False)
    dit = model.as_sampleable()
    seq_len = (PIPE_SHAPE[2] // config.patch) * (PIPE_SHAPE[3] // config.patch)
    mu = _calculate_shift(seq_len, FLUX_SCHEDULER_CONFIG)
    key = prng.PRNGKey(SEEDS[0])
    x_dit = prng.normal(prng.split(key)[0], PIPE_SHAPE, torch.float32, dev)  # GenerationPipeline's x0 for the key

    def flux_wrapper() -> SkrampleWrapperScheduler:
        wrapper = SkrampleWrapperScheduler.from_diffusers_config(
            FLUX_SCHEDULER_CONFIG, sampler=structured.UniPC, sampler_props={"order": 3}
        )
        wrapper.set_timesteps(STEPS, device=dev, mu=mu)
        return wrapper

    def dit_request(wrapper=None):
        with torch.inference_mode():
            return _scheduler_loop(wrapper or flux_wrapper(), dit, x_dit.to(torch.bfloat16))

    dit_want = {"fused_step_cuda": STEPS, "flash_attention_qkv_forward": DEPTH * STEPS,
                "adaln_forward": (2 * DEPTH + 1) * STEPS}
    dit_request()  # warm-up
    shifted = flux_wrapper()
    print(
        f"diffusers: FLUX.1-dev scheduler config -> {shifted.sampler}, {shifted.model}; mu {mu:.6f} for "
        f"{seq_len} tokens -> {shifted.schedule}"
    )
    wrapped = _pipeline_request("diffusers DiT UniPC(order=3)", dit_request, dit_want, total)
    with wrapper_plain:
        plain = dit_request()
    expect(torch.equal(wrapped, plain), f"diffusers DiT: K1 differs from the plain chain by {max_err(wrapped, plain)}")
    half = STEPS // 2
    first = flux_wrapper()
    with torch.inference_mode():
        x_half = _scheduler_loop(first, dit, x_dit.to(torch.bfloat16), last=half)
        state = first.state_dict()
        resumed = flux_wrapper()
        resumed.load_state_dict(state)
        x_resumed = _scheduler_loop(resumed, dit, x_half, first=half)
    resume_equal = torch.equal(x_resumed, wrapped)
    print(
        f"diffusers DiT: K1 (rows 3, f32) vs the wrapper's plain chain bit-equal True; a state_dict taken after "
        f"step {half} and loaded into a fresh wrapper finishes bit-equal {resume_equal} (tolerance 0)"
    )
    expect(resume_equal, "diffusers DiT: the resumed run differs from the uninterrupted one")
    pipe = GenerationPipeline(dit, structured.UniPC(order=3), shifted.schedule, models.FlowModel(), STEPS, PIPE_SHAPE,
                              device=dev)
    pipe_out = pipe.generate(SEEDS[0])
    # the wrapper hands the model bf16 latents and rounds x to bf16 after every step (relative 2**-9 at most);
    # the pipeline keeps x in f32.  Bound: 25 such roundings, added up, of the largest value
    tol = STEPS * 2.0**-9
    vs_pipe = _relative(wrapped, pipe_out)
    print(
        f"diffusers DiT: the wrapper's request vs GenerationPipeline(UniPC(order=3), the same schedule and x0): "
        f"relative max err {vs_pipe:.3e} (tolerance {tol:.3e}: {STEPS} bf16 roundings of x, 2**-9 each)"
    )
    expect(bool(torch.isfinite(wrapped).all()) and vs_pipe <= tol, f"diffusers DiT: wrapper vs pipeline {vs_pipe}")

    # latency: the two requests in turns (the host's load drifts between calls); then the host time of
    # one step of each, the wrapper's with its scale_model_input
    runs = {"GenerationPipeline": lambda: pipe.generate(SEEDS[0]), "wrapper": dit_request}
    times: dict[str, list[float]] = {label: [] for label in runs}
    for _ in range(PIPE_REPEATS):
        for label, run in runs.items():
            t0 = time.perf_counter()
            run().cpu()
            times[label].append((time.perf_counter() - t0) * 1e3)
    medians = {label: statistics.median(every) for label, every in times.items()}
    for label, every in times.items():
        print(
            f"diffusers DiT: request latency, {label} (UniPC(order=3), {STEPS} steps): median {medians[label]:.2f} "
            f"ms of {PIPE_REPEATS}, in turns with the other ({', '.join(f'{v:.2f}' for v in every)}; {card})"
        )
    stepper = flux_wrapper()
    t_mid = stepper.timesteps[STEPS // 2]
    x_mid = x_dit.to(torch.bfloat16)
    with torch.inference_mode():
        out_mid = dit(x_mid, t_mid, None, None)
        wrapper_us = host_us(lambda: stepper.step(out_mid, t_mid, x_mid, return_dict=False))
        scale_us = host_us(lambda: stepper.scale_model_input(x_mid, t_mid))
        denoiser = pipe._denoiser(0)
        x32, o32 = x_mid.float(), out_mid.float()
        ring = denoiser.init_ring(x32)
        denoiser_us = host_us(lambda: denoiser.step(denoiser.host_weights[STEPS // 2], x32, o32, ring))
    print(
        f"diffusers DiT: host time a step (median of 200 eager calls): the wrapper's step() {wrapper_us:.1f} us + "
        f"scale_model_input() {scale_us:.1f} us (each reads the timestep back) against the pipeline's "
        f"CompiledDenoiser.step {denoiser_us:.1f} us: the wrapper's cost a step "
        f"{wrapper_us + scale_us - denoiser_us:.1f} us; its request {medians['wrapper'] - medians['GenerationPipeline']:.2f} "
        f"ms over the pipeline's by median ({card})"
    )
    _traced_dispatch(lambda: dit_request().cpu(), "diffusers DiT wrapper", medians["wrapper"] / 1e3, card,
                     FLUX_GROUPS, share="K1 fused_step")

    # ---- d: the inside-out RK wrapper (RKUltra order 4) over the DiT: plain torch steps, no K1 ----
    rk_sampler = RKUltra(order=4)
    rk_steps = rk_sampler.adjust_steps(STEPS)
    rk_wrapper = RKUltraWrapperScheduler.from_diffusers_config(FLUX_SCHEDULER_CONFIG, sampler_order=4)
    rk_wrapper.set_timesteps(rk_steps, device=dev, mu=mu)
    calls = len(rk_wrapper.timesteps)
    rk_wrapped = _pipeline_request(
        "diffusers DiT RKUltraWrapperScheduler(order=4)",
        lambda: _scheduler_loop(rk_wrapper, dit, x_dit.to(torch.bfloat16)),
        {"flash_attention_qkv_forward": DEPTH * calls, "adaln_forward": (2 * DEPTH + 1) * calls},
        total,
    )
    print(
        f"diffusers DiT RKUltraWrapperScheduler(order=4): {rk_steps} steps of {rk_wrapper.order} stages presented as "
        f"{calls} timesteps, one model call each; finite {bool(torch.isfinite(rk_wrapped).all())}"
    )

    # ---- e: rk_sample_loop(RKUltra order 4) and AdaptivePipeline(RKMoire order 3) over the DiT ----
    schedule, transform = scheduling.FlowShift(scheduling.Linear()), models.FlowModel()
    stages, mixing, fused_steps = _rk_stage_counts(rk_sampler, schedule, rk_steps)
    model_calls: list[int] = []
    rk_sampler.sample_model(  # the model calls the loop makes (terminal stages it skips excluded), on the host
        torch.zeros(1, dtype=torch.float64), lambda x, t, s, a: model_calls.append(1) or x * 0.5, transform, schedule,
        rk_steps,
    )
    x_rk = prng.normal(prng.fold_in(prng.PRNGKey(SEEDS[4]), 0), PIPE_SHAPE, torch.float32, dev)

    def rk_run():
        with torch.inference_mode():
            return rk_sample_loop(rk_sampler, schedule, transform, rk_steps, dit, x_rk)

    rk_want = {"fused_step_cuda": fused_steps * (mixing + 1), "flash_attention_qkv_forward": DEPTH * len(model_calls),
               "adaln_forward": (2 * DEPTH + 1) * len(model_calls)}
    rk_out = _pipeline_request("rk_sample_loop(RKUltra(order=4))", rk_run, rk_want, total)
    with loop_plain:
        rk_k1_plain = rk_run()
    with (
        loop_plain,
        mock.patch.object(flash_attention, "flash_attention_qkv_forward", flash_attention._qkv_reference),
        mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
    ):
        rk_plain = rk_run()
    with torch.inference_mode():
        eager = rk_sampler.sample_model(x_rk, dit, transform, schedule, rk_steps)
    vs_plain, vs_eager = _relative(rk_out, rk_plain), _relative(rk_out, eager)
    print(
        f"rk_sample_loop(RKUltra(order=4)): {rk_steps} steps of {stages} stages ({mixing} mixing), {fused_steps} on "
        f"the fused path: K1 {rk_want['fused_step_cuda']} launches; K1 vs its plain version bit-equal "
        f"{torch.equal(rk_out, rk_k1_plain)} (tolerance 0); K1-K3 vs the plain versions relative max err "
        f"{vs_plain:.3e} (tolerance 5e-2, bf16); vs phase 12's eager RKUltra loop {vs_eager:.3e} (tolerance 5e-2: "
        f"the fused steps fold the weights in float64 and round once, the eager loop rounds each product)"
    )
    expect(torch.equal(rk_out, rk_k1_plain), "rk_sample_loop: K1 differs from its plain version")
    expect(bool(torch.isfinite(rk_plain).all()) and vs_plain <= 5e-2, f"rk_sample_loop: kernels vs plain {vs_plain}")
    expect(vs_eager <= 5e-2, f"rk_sample_loop: vs the eager loop {vs_eager}")
    rk_ms = _median_ms(rk_run)[0]
    _traced_dispatch(lambda: rk_run().cpu(), "rk_sample_loop(RKUltra(order=4))", rk_ms / 1e3, card, FLUX_GROUPS,
                     share="K1 fused_step")

    adaptive = AdaptivePipeline(dit, RKMoire(order=3), schedule, transform, STEPS, PIPE_SHAPE, device=dev)
    adaptive.generate(SEEDS[5])  # warm-up
    torch.cuda.synchronize()
    _reset_counters()
    out, accepted, trials = adaptive.generate(SEEDS[5])
    torch.cuda.synchronize()
    launches = _counters()
    plan = adaptive.plan
    calls = trials * plan.stages + plan.stages - len(plan.skip)
    moire_mixing = sum(plan.has_a)
    moire_want = {name: 0 for name in launches} | {
        "fused_step_cuda": (trials + 1) * (moire_mixing + 1),
        "flash_attention_qkv_forward": DEPTH * calls,
        "adaln_forward": (2 * DEPTH + 1) * calls,
    }
    print(
        f"AdaptivePipeline(RKMoire(order=3)): {accepted} accepted steps (the final hop among them) in {trials} "
        f"trials + the final hop, "
        f"{plan.stages}-stage pair ({moire_mixing} mixing, {len(plan.skip)} skipped at t = 0); launches "
        f"{{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}"
    )
    expect(launches == moire_want, f"AdaptivePipeline: launched {launches}, expected {moire_want}")
    expect(bool(torch.isfinite(out).all()) and tuple(out.shape) == PIPE_SHAPE, "AdaptivePipeline: bad output")
    for name, count in launches.items():
        total[name] += count
    with loop_plain:
        plain_out, plain_accepted, plain_trials = adaptive.generate(SEEDS[5])
    adaptive_equal = torch.equal(out, plain_out) and (accepted, trials) == (plain_accepted, plain_trials)
    print(f"AdaptivePipeline: K1 vs its plain version: the same trials and bit-equal {adaptive_equal} (tolerance 0)")
    expect(adaptive_equal, "AdaptivePipeline: K1 differs from its plain version")
    adaptive_ms, every = _median_ms(lambda: adaptive.generate(SEEDS[5])[0])
    print(
        f"AdaptivePipeline: request latency median {adaptive_ms:.2f} ms of {PIPE_REPEATS} "
        f"({', '.join(f'{v:.2f}' for v in every)}; one error read back a trial; {card})"
    )
    del model
    torch.cuda.empty_cache()
    print(f"diffusers: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


GRAPH_REPEATS = 5  # requests (or batches) per latency median of phase 14, eager and graphed in turns
STAGGER_SEEDS = tuple(range(21, 29))  # phase 14's 8 staggered arrivals
STAGGER_GAP_S = 0.010  # between two arrivals: about two ticks of the eager 4-slot pool


def _same(got, want) -> tuple[bool, float]:
    "Bit-equal, and the largest absolute difference, of two sequences of tensors (compared on the host)."
    import torch

    pairs = [(a.cpu(), b.cpu()) for a, b in zip(got, want, strict=True)]
    return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs), max(max_err(a, b) for a, b in pairs)


def _arrivals(engine, seeds, gap_s: float) -> tuple[list, list[float]]:
    """Submit ``seeds`` one every ``gap_s``; the results, and each request's latency in ms from its submission
    to the card finishing it.  A future resolves once its work is enqueued, so the worker's done callback
    records a CUDA event on its stream; the events' times from one recorded on an idle card at the start put
    the completions on the host clock."""
    import torch

    done: dict[int, object] = {}

    def finished(i: int) -> None:
        done[i] = torch.cuda.Event(enable_timing=True)
        done[i].record()

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    futs, sent = [], []
    for i, seed in enumerate(seeds):
        sent.append((time.perf_counter() - t0) * 1e3)
        fut = engine.submit(seed)
        fut.add_done_callback(lambda _f, i=i: finished(i))
        futs.append(fut)
        time.sleep(gap_s)
    outs = [f.result() for f in futs]
    torch.cuda.synchronize()
    return outs, [start.elapsed_time(done[i]) - sent[i] for i in range(len(seeds))]


def graphs_phase(card: str, dit_outputs: dict, parts: dict) -> dict[str, int]:
    """Phase 14: A2's second half over phase 3's DiT-512/8 (bf16, the same random tree, 25-step DPM++2M over
    FlowShift(Linear)).  (b) ``ServingEngine(graph=True)``: phase 3's 6 requests (4 together, then 2) as
    replays of one CUDA graph a bucket, bit for bit phase 3's eager results, with phase 3's launches a
    replayed dispatch; latency and images per second in turns with the eager engine, a traced request of
    each; ``GenerationPipeline(stochasticity 0.3, graph=True)`` (``run(key=, graph=True)``) bit for bit phase
    12's eager key-drawn request.  (c) ``ContinuousServingEngine(slots=4)``, eager and graphed, 1 and 5 ticks
    a dispatch: 4 requests admitted in one tick == phase 3's bucket of 4; 8 staggered arrivals == each
    alone in the pool; K1 swapped for its plain version == K1; one K1 launch a tick step, in the
    device-weights mode; occupancy and latency under the staggered arrivals against the batch engine.  (d)
    ``GraphedTrainStep`` over phase 4's configuration (batch 4, AdamW ``capturable=True``, EMA): 5 steps ==
    the eager ``train_step`` with the same optimizer, bit for bit; phase 4's launches a replay; the median of
    20 steps and a traced step, eager and graphed.  Returns the launches of every counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skrample_tpu_torch import scheduling, training
    from skrample_tpu_torch.continuous import ContinuousServingEngine
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, cast_dense_weights, random_param_tree
    from skrample_tpu_torch.models.ema import ema_init
    from skrample_tpu_torch.ops import fused
    from skrample_tpu_torch.pipeline import GenerationPipeline
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    config = DiTConfig(
        dim=512, depth=DEPTH, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash"
    )
    tree = random_param_tree(config, seed=0)
    # the dense weights stored in bf16 once (ROADMAP C6), not cast at every call: the same bits as phase 3's
    model = cast_dense_weights(DiT(config, device=dev).load_jax_params(tree).requires_grad_(False), torch.bfloat16)
    sampler, schedule, transform = structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel()
    item = (4, 64, 64)

    def per_steps(steps: int) -> dict[str, int]:
        "K1 once a step, K2 once a block and K3 2 x depth + 1 times a forward."
        return {"fused_step_cuda": steps, "flash_attention_qkv_forward": DEPTH * steps, "adaln_forward": (2 * DEPTH + 1) * steps}

    # ---- b: ServingEngine(graph=True), phase 3's 6 requests ----
    def serving_engine(graph: bool) -> ServingEngine:
        return ServingEngine(
            model.as_sampleable(), item, sampler, schedule, transform, STEPS, dtype=torch.float32, buckets=(1, 2, 4),
            max_delay_ms=50.0, device=dev, graph=graph,
        )

    def four_then_two(engine: ServingEngine):
        first = [engine.submit(s) for s in SEEDS[:4]]
        outs = [f.result() for f in first]
        second = [engine.submit(s) for s in SEEDS[4:]]
        return torch.stack(outs + [f.result() for f in second])

    eager, graphed = serving_engine(False), serving_engine(True)
    with eager, graphed:
        eager.generate(99).cpu()
        four_then_two(graphed)  # the first dispatch of buckets 4 and 2: warm-up, capture, replay
        graphed.generate(99).cpu()  # bucket 1
        batches_before = graphed.stats.batches
        served = _pipeline_request(
            "ServingEngine(graph=True), 6 requests (4 together, then 2)", lambda: four_then_two(graphed),
            per_steps(2 * STEPS), total, phase="graphs",
        )
        modes = dict(fused.fused_step_cuda.modes)
        dispatches = graphed.stats.batches - batches_before
        expect(dispatches == 2, f"graphs serving: expected 2 dispatches (4 + 2), got {dispatches}")
        expect(modes == {"value": 2 * STEPS, "device": 0}, f"graphs serving: K1 by mode {modes}")
        for key, captured in graphed._graphs.items():
            per_replay = captured.tally.per_replay()
            print(f"graphs serving: the graph of (bucket, start, context) {key}: launches a replay {per_replay}")
            expect(per_replay == per_steps(STEPS), f"graphs serving: graph {key} replays {per_replay}")
        equal, err = _same(served, [dit_outputs[seed] for seed in SEEDS])
        print(
            f"graphs serving: 6 replayed requests vs phase 3's eager ones of the same seeds: bit-equal {equal}, "
            f"max abs err {err:.3e} (tolerance 0)"
        )
        expect(equal, f"graphs serving: the graphed requests differ from phase 3's by {err}")

        eager.max_delay_s = graphed.max_delay_s = 2e-3  # phase 3's latency window
        solo: dict[str, list[float]] = {"eager": [], "graph": []}
        four: dict[str, list[float]] = {"eager": [], "graph": []}
        for i in range(GRAPH_REPEATS):
            for label, engine in (("eager", eager), ("graph", graphed))[:: 1 if i % 2 else -1]:
                t0 = time.perf_counter()
                engine.generate(400 + i).cpu()
                solo[label].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                for f in [engine.submit(500 + 4 * i + j) for j in range(4)]:
                    f.result().cpu()
                four[label].append((time.perf_counter() - t0) * 1e3)
        medians = {label: statistics.median(solo[label]) for label in solo}
        for label in ("eager", "graph"):
            batch = statistics.median(four[label])
            print(
                f"graphs serving {label}: request latency, bucket 1: median {medians[label]:.2f} ms of {GRAPH_REPEATS} "
                f"({', '.join(f'{v:.2f}' for v in solo[label])}); batch of 4: median {batch:.2f} ms, "
                f"{4e3 / batch:.2f} img/s ({card})"
            )
        traced: dict = {"median_ms": medians["graph"]}
        parts["graphed_dit"] = traced  # phase 16e prints it beside the numbers before ROADMAP C6's repair
        for label, engine in (("eager", eager), ("graph", graphed)):
            _traced_dispatch(
                lambda engine=engine: engine.generate(600).cpu(), f"graphs serving {label}", medians[label] / 1e3,
                card, FLUX_GROUPS, record=traced if label == "graph" else None,
            )

    pipe = GenerationPipeline(
        model.as_sampleable(), structured.DPM(order=2, stochasticity=0.3), schedule, transform, STEPS, PIPE_SHAPE,
        device=dev, graph=True,
    )
    pipe.generate(98).cpu()  # capture
    got = _pipeline_request(
        "GenerationPipeline(stochasticity 0.3, graph=True)", lambda: pipe.generate(SEEDS[1]), per_steps(STEPS),
        total, phase="graphs",
    )
    equal, err = _same([got], [parts["pipeline_stochastic"]])
    print(
        f"graphs pipeline: run(key=, graph=True) (every step's noise drawn before the replay) vs phase 12's eager "
        f"in-loop draws, seed {SEEDS[1]}: bit-equal {equal}, max abs err {err:.3e} (tolerance 0)"
    )
    expect(equal, f"graphs pipeline: the graphed key-drawn request differs from phase 12's by {err}")
    del pipe

    # ---- c: ContinuousServingEngine(slots=4), eager and graphed ----
    def pool(graph: bool, ticks: int = 1) -> ContinuousServingEngine:
        return ContinuousServingEngine(
            model.as_sampleable(), item, sampler, schedule, transform, STEPS, dtype=torch.float32, slots=4,
            ticks_per_dispatch=ticks, device=dev, graph=graph,
        )

    def together(engine: ContinuousServingEngine):
        "SEEDS[:4] admitted in one tick (checked: every dispatch of the run had 4 live slots)."
        for _attempt in range(3):
            ticks, fours = engine.stats.ticks, engine.stats.bucket_counts.get(4, 0)
            outs = torch.stack([f.result() for f in [engine.submit(s) for s in SEEDS[:4]]])
            if engine.stats.bucket_counts.get(4, 0) - fours == engine.stats.ticks - ticks:
                return outs
        raise SmokeFailure("continuous: the 4 requests were never admitted in one tick")

    def counted(label: str, engine: ContinuousServingEngine, run):
        "A main-path run: K1 once a tick step in the device-weights mode, K2 and K3 a 4-slot forward's."
        torch.cuda.synchronize()
        _reset_counters()
        ticks = engine.stats.ticks
        out = run(engine)
        torch.cuda.synchronize()
        launches = _counters()
        steps_run = (engine.stats.ticks - ticks) * engine.ticks_per_dispatch
        want = dict.fromkeys(launches, 0)
        want.update(per_steps(steps_run))
        print(f"graphs continuous {label}: {steps_run} tick steps, launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}")
        expect(launches == want, f"continuous {label}: launched {launches}, expected {want}")
        expect(fused.fused_step_cuda.modes == {"value": 0, "device": steps_run}, f"continuous {label}: K1 {fused.fused_step_cuda.modes}")
        for name, count in launches.items():
            total[name] += count
        return out

    results: dict[str, object] = {}
    with pool(False) as engine:
        results["eager 1 tick"] = counted("eager, 4 admitted in one tick", engine, together)
        alone = {seed: engine.generate(seed) for seed in STAGGER_SEEDS}  # each alone in the pool
        with mock.patch("skrample_tpu_torch.ops.loop.fused_step_indexed_cuda", fused.fused_step_indexed):
            _reset_counters()
            plain = together(engine)
            expect(fused.fused_step_cuda.launches == 0, "continuous: the plain K1 run launched K1")
        engine.stats.active_slot_steps = engine.stats.slot_steps = 0  # occupancy of the staggered run alone
        stagger, eager_lat = counted(
            "eager, 8 staggered arrivals", engine, lambda e: _arrivals(e, STAGGER_SEEDS, STAGGER_GAP_S)
        )
        occupancy = {"eager": engine.stats.occupancy}
    equal, err = _same(results["eager 1 tick"], [dit_outputs[seed] for seed in SEEDS[:4]])
    print(
        f"graphs continuous: 4 requests admitted in one tick vs phase 3's bucket of 4 (ServingEngine, same seeds): "
        f"bit-equal {equal}, max abs err {err:.3e} (tolerance 0: the same batch, kernels and chain)"
    )
    expect(equal, f"continuous: the pooled requests differ from ServingEngine's bucket of 4 by {err}")
    equal, err = _same(plain, results["eager 1 tick"])
    print(f"graphs continuous: K1's device-weights mode vs its plain version, 4 requests: bit-equal {equal}, max abs err {err:.3e} (tolerance 0)")
    expect(equal, f"continuous: K1 differs from its plain version by {err}")
    equal, err = _same(stagger, [alone[seed] for seed in STAGGER_SEEDS])
    print(f"graphs continuous: 8 staggered arrivals vs each alone in the pool: bit-equal {equal}, max abs err {err:.3e} (tolerance 0)")
    expect(equal, f"continuous: staggered requests differ from their solo runs by {err}")

    latency = {"continuous eager": eager_lat}
    for graph, ticks in ((False, 5), (True, 1), (True, 5)):
        label = f"{'graphed' if graph else 'eager'}, {ticks} tick{'s' if ticks > 1 else ''} a dispatch"
        with pool(graph, ticks) as engine:
            got = counted(f"{label}, 4 admitted in one tick", engine, together)
            equal, err = _same(got, results["eager 1 tick"])
            print(f"graphs continuous {label}: 4 requests vs the eager 1-tick run: bit-equal {equal}, max abs err {err:.3e} (tolerance 0)")
            expect(equal, f"continuous {label}: differs from the eager 1-tick run by {err}")
            if graph:
                per_replay = engine._graph.tally.per_replay()
                print(f"graphs continuous {label}: launches a replay {per_replay}")
                expect(per_replay == per_steps(ticks), f"continuous {label}: a replay launches {per_replay}")
                engine.stats.active_slot_steps = engine.stats.slot_steps = 0
                got, lat = counted(
                    f"{label}, 8 staggered arrivals", engine, lambda e: _arrivals(e, STAGGER_SEEDS, STAGGER_GAP_S)
                )
                equal, err = _same(got, [alone[seed] for seed in STAGGER_SEEDS])
                print(f"graphs continuous {label}: 8 staggered arrivals vs each alone: bit-equal {equal}, max abs err {err:.3e} (tolerance 0)")
                expect(equal, f"continuous {label}: staggered requests differ from their solo runs by {err}")
                latency[f"continuous {label}"] = lat
                occupancy[label] = engine.stats.occupancy
    with serving_engine(True) as batch_engine:
        batch_engine.max_delay_s = 2e-3
        four_then_two(batch_engine)  # capture buckets 4 and 2
        batch_engine.generate(99).cpu()  # and 1
        _outs, latency["ServingEngine graphed"] = _arrivals(batch_engine, STAGGER_SEEDS, STAGGER_GAP_S)
        batch_buckets = dict(batch_engine.stats.bucket_counts)
    for label, values in latency.items():
        print(
            f"graphs arrivals every {STAGGER_GAP_S * 1e3:.0f} ms, {label}: request latency median "
            f"{statistics.median(values):.2f} ms, max {max(values):.2f} ({', '.join(f'{v:.1f}' for v in values)}; {card})"
        )
    print(
        f"graphs continuous: occupancy under the staggered arrivals {', '.join(f'{k} {v:.3f}' for k, v in occupancy.items())}; "
        f"ServingEngine buckets {batch_buckets}"
    )

    # ---- d: GraphedTrainStep over phase 4's configuration ----
    data = training.synthetic_dataset(64, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [training.draw_batch(data, 4, gen) for _ in range(5)]
    per_train = dict.fromkeys(_wrappers(), 0)
    per_train.update(
        adaln_forward=2 * DEPTH + 1, flash_attention_qkv_forward_lse=DEPTH, flash_attention_qkv_backward=DEPTH,
        adaln_backward=2 * DEPTH + 1,
    )
    states = {}
    for graph in (False, True):
        net = DiT(config, device=dev).load_jax_params(tree)
        opt = training.make_optimizer(net, capturable=True)
        ema = ema_init(net)
        step = training.GraphedTrainStep(net, opt, ema) if graph else None
        torch.cuda.synchronize()
        _reset_counters()
        losses = [
            step(*batch).clone() if graph else training.train_step(net, opt, ema, *batch, step=i)
            for i, batch in enumerate(batches)
        ]
        torch.cuda.synchronize()
        launches = _counters()
        want = {name: count * len(batches) for name, count in per_train.items()}
        expect(launches == want, f"graphs train ({'graphed' if graph else 'eager'}): launched {launches}, expected {want}")
        for name, count in launches.items():
            total[name] += count
        if graph:
            per_replay = step._graph.tally.per_replay()
            print(f"graphs train: launches a replayed step {per_replay} (phase 4's a step)")
            expect(per_replay == {k: v for k, v in per_train.items() if v}, f"graphs train: a replay launches {per_replay}")
        adam = [opt.state[p][name] for p in net.parameters() for name in ("exp_avg", "exp_avg_sq", "step")]
        states[graph] = (net, opt, ema, step, [torch.stack(losses), *net.parameters(), *adam, *ema.values()])
    equal, err = _same(states[True][4], states[False][4])
    print(
        f"graphs train: 5 steps, GraphedTrainStep vs the eager train_step (AdamW capturable=True, EMA): losses, "
        f"parameters, AdamW state and EMA bit-equal {equal}, max abs err {err:.3e} (tolerance 0)"
    )
    expect(equal, f"graphs train: the graphed steps differ from the eager ones by {err}")
    medians = {}
    for graph in (False, True):
        net, opt, ema, step, _ = states[graph]
        times = []
        for i in range(TRAIN_STEPS):
            batch = batches[i % len(batches)]
            t0 = time.perf_counter()
            step(*batch) if graph else training.train_step(net, opt, ema, *batch, step=len(batches) + i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        medians[graph] = statistics.median(times)
        label = "graphed" if graph else "eager (capturable AdamW)"
        print(
            f"graphs train {label}: step time median {medians[graph]:.2f} ms (min {min(times):.2f}, max "
            f"{max(times):.2f}; {TRAIN_STEPS} steps, batch 4 of 4x64x64, DiT-512/8 bf16; {card})"
        )
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            for i in range(3):
                step(*batches[i]) if graph else training.train_step(net, opt, ema, *batches[i], step=100 + i)
            torch.cuda.synchronize()
        _kernel_ms, kernel_launches, busy = card_time(prof)
        busy /= 3
        print(
            f"graphs train {label} profile: card busy {busy:.3f} ms of the {medians[graph]:.2f} ms median step: idle "
            f"{100 * (1 - busy / medians[graph]):.1f}%; {sum(kernel_launches.values()) / 3:g} kernel launches a step ({card})"
        )
    print(f"graphs: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


EXTRA_STEPS = 5  # 15a/15b: steps of the eager and the graphed run held bit for bit
EXTRA_TIMED = 10  # 15a/15b: steps per step-time median
RESUME_UNTIL, RESUME_ABORT, RESUME_EVERY = 8, 4, 2  # 15c: the kill-and-resume recipe
FLUX_TRAIN_STEPS = 3  # 15d


def _train_per_step(depth: int = DEPTH) -> dict[str, int]:
    "Phase 4's launches a DiT training step."
    per = dict.fromkeys(_wrappers(), 0)
    per.update(
        adaln_forward=2 * depth + 1, flash_attention_qkv_forward_lse=depth, flash_attention_qkv_backward=depth,
        adaln_backward=2 * depth + 1,
    )
    return per


def _counted_run(label: str, want: dict[str, int], run, total: dict[str, int]):
    "A main-path run: the counters from 0 just before, read just after, held to ``want`` and added to ``total``."
    import torch

    torch.cuda.synchronize()
    _reset_counters()
    out = run()
    torch.cuda.synchronize()
    launches = _counters()
    print(f"extras {label}: launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}")
    expect(launches == want, f"extras {label}: launched {launches}, expected {want}")
    for name, count in launches.items():
        total[name] += count
    return out


def _median_step_ms(step, n: int = EXTRA_TIMED) -> tuple[float, float, float]:
    "Median, min and max of ``n`` synchronized steps on the host clock (ms)."
    import torch

    times = []
    for i in range(n):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def _optimizer_card_ms(prof, prefix: str) -> float:
    "The card time of the kernels launched inside the optimizer's own profiler range (``Optimizer.step#...``)."
    import torch

    return sum(
        e.device_time_total for e in prof.events()
        if e.name.startswith(prefix) and e.device_type == torch.autograd.DeviceType.CPU
    ) / 1e3


def _relative_fro_all(a: list, b: list) -> float:
    "Relative Frobenius distance of two gradient lists taken as one vector."
    num = sum(float((x.double() - y.double()).square().sum()) for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return math.sqrt(num / max(den, 1e-300))


def extras_phase(card: str) -> dict[str, int]:
    """Phase 15: the rest of training (ROADMAP A7) and C13's Flux head dims.  (a) ``optim.AdamW8bit`` on phase
    4's DiT-512/8: eager == graphed over 5 steps bit for bit, its state bytes against AdamW's, step times, peak
    memory, the optimizer's card time against a graphed step's; (b) LoRA rank 16 on the same DiT: identity at
    init, eager == graphed, the base untouched, step times; (c) ``prefetch_to_device(EpochLoader)`` on the card
    == ``batch_at``, then ``python -m skrample_tpu_torch.training --device cuda`` killed and resumed == an
    uninterrupted run, bit for bit, with AdamW and with ``--opt8 --graph``; (d) a 1.31B Flux-width fine-tune
    (FLUX.1's widths, 2 double + 4 single blocks, bf16) with ``AdamW8bit(1e-5, cast_updates=False)`` and
    stochastic rounding: 3 steps, a step against the plain versions, then a ``--lora 16`` step; (e)
    ``VAE.loss`` (the SDXL VAE, f32, 256x256) and ``VideoVAE.loss`` (phase 10's widths, bf16, 4 frames of
    128x128), fused decode against the composition; (f) a Flux at head dim 64 (``"flash"``: B10's body, and
    ``"full"``) and 96 (``"full"``: B7's run-time-d body) against the plain versions.  Returns the launches."""
    import torch

    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    total.update({"rope_qk_norm_forward d64": 0, "rope_qk_norm_forward d96": 0})
    for part in (_opt8_part, _lora_part, _resume_part, _flux_finetune_part, _vae_loss_part, _flux_head_dims_part):
        t0 = time.perf_counter()
        part(card, total)
        torch.cuda.empty_cache()
        print(f"extras: {part.__name__} took {time.perf_counter() - t0:.1f} s")
    print(f"extras: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


def _dit512():
    import torch

    from skrample_tpu_torch.models.dit import DiTConfig, random_param_tree

    config = DiTConfig(dim=512, depth=DEPTH, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash")
    return config, random_param_tree(config, seed=0)


def _opt8_part(card: str, total: dict[str, int]) -> None:
    "15a: AdamW8bit on phase 4's DiT-512/8 (bf16 compute, f32 masters, batch 4)."
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skrample_tpu_torch import training
    from skrample_tpu_torch.models.dit import DiT
    from skrample_tpu_torch.models.ema import ema_init
    from skrample_tpu_torch.models.lora import jax_leaves
    from skrample_tpu_torch.optim import AdamW8bit, optimizer_state_bytes

    dev = torch.device("cuda")
    config, tree = _dit512()
    data = training.synthetic_dataset(64, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [training.draw_batch(data, 4, gen) for _ in range(EXTRA_STEPS)]
    per = _train_per_step()
    runs = {}
    for graph in (False, True):
        net = DiT(config, device=dev).load_jax_params(tree)
        opt = AdamW8bit([leaf.tensor for leaf in jax_leaves(net)], lr=1e-4, capturable=True)
        ema = ema_init(net)
        step = training.GraphedTrainStep(net, opt, ema) if graph else None
        label = "graphed" if graph else "eager"

        def run(net=net, opt=opt, ema=ema, step=step):
            return [
                step(*b).clone() if step is not None else training.train_step(net, opt, ema, *b, step=i)
                for i, b in enumerate(batches)
            ]

        losses = _counted_run(f"15a AdamW8bit {label}, {EXTRA_STEPS} steps", {k: v * EXTRA_STEPS for k, v in per.items()}, run, total)
        if graph:
            per_replay = step._graph.tally.per_replay()
            expect(per_replay == {k: v for k, v in per.items() if v}, f"15a: a replay launches {per_replay}")
        moments = [t for p in opt._params() for t in opt.state[p].values()] + [opt.state["count"]]
        runs[graph] = (net, opt, ema, step, [torch.stack(losses), *net.parameters(), *moments, *ema.values()])
    equal, err = _same(runs[True][4], runs[False][4])
    print(
        f"extras 15a: {EXTRA_STEPS} steps, GraphedTrainStep vs train_step with AdamW8bit(capturable=True): losses, "
        f"parameters, int8 codes, scales, count and EMA bit-equal {equal}, max abs err {err:.3e} (tolerance 0)"
    )
    expect(equal, f"15a: the graphed AdamW8bit steps differ from the eager ones by {err}")
    net, opt, ema, step, _ = runs[False]
    n_params = sum(p.numel() for p in net.parameters())
    adamw_net = DiT(config, device=dev).load_jax_params(tree)
    adamw = training.make_optimizer(adamw_net)
    training.train_step(adamw_net, adamw, ema_init(adamw_net), *batches[0], step=0)
    per8 = optimizer_state_bytes(opt.state_dict()) / n_params
    per32 = optimizer_state_bytes(adamw.state_dict()) / n_params
    print(
        f"extras 15a: optimizer state {per8:.4f} bytes a parameter (AdamW8bit) against {per32:.4f} (AdamW), "
        f"{n_params / 1e6:.2f}M parameters"
    )
    expect(per8 < 2.1 and per32 >= 8, f"15a: state bytes {per8} and {per32} a parameter")
    del adamw_net, adamw
    medians = {}
    for graph in (False, True):
        net, opt, ema, step, _ = runs[graph]
        torch.cuda.reset_peak_memory_stats()
        if graph:
            med, lo, hi = _median_step_ms(lambda i, step=step: step(*batches[i % EXTRA_STEPS]))
        else:
            med, lo, hi = _median_step_ms(lambda i, net=net, opt=opt, ema=ema: training.train_step(net, opt, ema, *batches[i % EXTRA_STEPS], step=EXTRA_STEPS + i))
        medians[graph] = med
        label = "graphed" if graph else "eager"
        print(
            f"extras 15a AdamW8bit {label}: step time median {med:.2f} ms (min {lo:.2f}, max {hi:.2f}; {EXTRA_TIMED} "
            f"steps, batch 4 of 4x64x64, DiT-512/8 bf16); peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})"
        )
    net, opt, ema, step, _ = runs[False]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(3):
            training.train_step(net, opt, ema, *batches[i], step=100 + i)
        torch.cuda.synchronize()
    opt_ms = _optimizer_card_ms(prof, "Optimizer.step#AdamW8bit") / 3
    _ms, _launches, eager_busy = card_time(prof)
    net, opt, ema, step, _ = runs[True]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(3):
            step(*batches[i])
        torch.cuda.synchronize()
    _ms, _launches, busy = card_time(prof)
    busy /= 3
    print(
        f"extras 15a AdamW8bit: the optimizer's kernels {opt_ms:.3f} ms a step on the card (eager trace, its "
        f"profiler range), {100 * opt_ms / busy:.1f}% of a graphed step's card busy {busy:.3f} ms (idle "
        f"{100 * (1 - busy / medians[True]):.1f}% of its {medians[True]:.2f} ms median; eager busy "
        f"{eager_busy / 3:.3f} ms) ({card})"
    )


def _lora_part(card: str, total: dict[str, int]) -> None:
    "15b: LoRA rank 16 on phase 4's DiT-512/8, AdamW (capturable) on the adapters."
    import torch

    from skrample_tpu_torch import prng, training
    from skrample_tpu_torch.models.dit import DiT
    from skrample_tpu_torch.models.ema import ema_init
    from skrample_tpu_torch.models.lora import lora_init, lora_param_count

    dev = torch.device("cuda")
    config, tree = _dit512()
    data = training.synthetic_dataset(64, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [training.draw_batch(data, 4, gen) for _ in range(EXTRA_STEPS)]
    per = _train_per_step()
    runs = {}
    for graph in (False, True):
        base = DiT(config, device=dev).load_jax_params(tree)
        lora = training.LoRAModel(base, lora_init(prng.PRNGKey(2), base, rank=16))
        if not graph:
            x0, noise, sigma = batches[0]
            with torch.no_grad():
                same = torch.equal(lora(x0, sigma * 1000.0), base(x0, sigma * 1000.0))
            n_ad, n_base = lora_param_count(lora.adapters), sum(p.numel() for p in base.parameters())
            print(f"extras 15b: LoRA rank 16, {n_ad} of {n_base} parameters trained; merged forward == base at init: {same}")
            expect(same, "15b: the merged model differs from the base at init")
        opt = training.make_optimizer(lora, capturable=True)
        ema = ema_init(lora)
        step = training.GraphedTrainStep(lora, opt, ema) if graph else None
        label = "graphed" if graph else "eager"

        def run(lora=lora, opt=opt, ema=ema, step=step):
            return [
                step(*b).clone() if step is not None else training.train_step(lora, opt, ema, *b, step=i)
                for i, b in enumerate(batches)
            ]

        losses = _counted_run(f"15b LoRA {label}, {EXTRA_STEPS} steps", {k: v * EXTRA_STEPS for k, v in per.items()}, run, total)
        adam = [t for p in lora.parameters() for t in opt.state[p].values()]
        runs[graph] = (lora, opt, ema, step, base, [torch.stack(losses), *lora.parameters(), *adam, *ema.values()])
    equal, err = _same(runs[True][5], runs[False][5])
    print(
        f"extras 15b: {EXTRA_STEPS} LoRA steps, graphed (the merge captured) vs eager: losses, adapters, AdamW state "
        f"and EMA bit-equal {equal}, max abs err {err:.3e} (tolerance 0)"
    )
    expect(equal, f"15b: the graphed LoRA steps differ from the eager ones by {err}")
    fresh = DiT(config, device=dev).load_jax_params(tree)
    for graph in (False, True):
        base = runs[graph][4]
        untouched = all(torch.equal(a, b) for a, b in zip(base.parameters(), fresh.parameters()))
        expect(untouched, f"15b: the frozen base moved ({'graphed' if graph else 'eager'})")
    print("extras 15b: the frozen base's parameters bit-equal to the loaded tree after the steps (eager and graphed)")
    for graph in (False, True):
        lora, opt, ema, step, base, _ = runs[graph]
        torch.cuda.reset_peak_memory_stats()
        if graph:
            med, lo, hi = _median_step_ms(lambda i, step=step: step(*batches[i % EXTRA_STEPS]))
        else:
            med, lo, hi = _median_step_ms(lambda i, lora=lora, opt=opt, ema=ema: training.train_step(lora, opt, ema, *batches[i % EXTRA_STEPS], step=EXTRA_STEPS + i))
        print(
            f"extras 15b LoRA {'graphed' if graph else 'eager'}: step time median {med:.2f} ms (min {lo:.2f}, max "
            f"{hi:.2f}); peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})"
        )


def _resume_part(card: str, total: dict[str, int]) -> None:
    "15c: the loader on the card, then the training CLI killed and resumed against an uninterrupted run."
    import itertools

    import torch

    from skrample_tpu_torch import prng, training
    from skrample_tpu_torch.data import EpochLoader, prefetch_to_device
    from skrample_tpu_torch.models.checkpoint import TrainCheckpointer

    dev = torch.device("cuda")
    loader = EpochLoader({"x0": training.host_dataset(16)}, 8, prng.PRNGKey(7))
    got = list(itertools.islice(prefetch_to_device(loader.iter_from(3), device=dev), 12))  # across an epoch's end
    torch.cuda.synchronize()
    same = all(b["x0"].is_cuda and torch.equal(b["x0"], loader.batch_at(3 + i)["x0"].to(dev)) for i, b in enumerate(got))
    print(f"extras 15c: prefetch_to_device(EpochLoader.iter_from(3)) on the card, 12 batches == batch_at(n): {same}")
    expect(same, "15c: a prefetched batch differs from batch_at")
    base = [
        sys.executable, "-m", "skrample_tpu_torch.training", "--device", "cuda", "--dim", "512", "--heads", "4",
        "--depth", "2", "--host-loader", "--until", str(RESUME_UNTIL), "--save-every", str(RESUME_EVERY),
    ]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    modes = {"AdamW": [], "--opt8 --graph": ["--opt8", "--graph"]}
    with tempfile.TemporaryDirectory() as tmp:

        def start(mode: str, tag: str, *extra: str) -> subprocess.Popen:
            cmd = [*base, *modes[mode], "--orbax", str(Path(tmp) / f"{mode.replace(' ', '')}-{tag}"), *extra]
            return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def finish(proc: subprocess.Popen) -> tuple[int, str, str]:
            try:
                out, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            return proc.returncode, out, err

        t0 = time.perf_counter()
        first = {(m, tag): start(m, tag, *extra) for m in modes for tag, extra in
                 (("straight", ()), ("killed", ("--abort-after-step", str(RESUME_ABORT))))}
        results = {key: finish(proc) for key, proc in first.items()}
        for mode in modes:
            rc, out, err = results[(mode, "straight")]
            expect(rc == 0, f"15c {mode}: the uninterrupted run failed ({rc}): {err[-1500:]}")
            rc, out, err = results[(mode, "killed")]
            expect(rc == -9 and f"aborting after step {RESUME_ABORT}" in out, f"15c {mode}: the kill run ended {rc}: {err[-1500:]}")
        second = {m: start(m, "killed", "--resume") for m in modes}
        resumed = {m: finish(p) for m, p in second.items()}
        for mode in modes:
            rc, out, err = resumed[mode]
            expect(rc == 0 and "resumed from" in out, f"15c {mode}: the resumed run failed ({rc}): {err[-1500:]}")
            at = int(out.split("at step")[1].split()[0])
            a = TrainCheckpointer(Path(tmp) / f"{mode.replace(' ', '')}-straight").restore(RESUME_UNTIL)
            b = TrainCheckpointer(Path(tmp) / f"{mode.replace(' ', '')}-killed").restore(RESUME_UNTIL)
            checks = {}
            for part in ("params", "opt_state", "ema"):
                flat_a, flat_b = _flat_tensors(a[part]), _flat_tensors(b[part])
                checks[part] = flat_a.keys() == flat_b.keys() and _same(list(flat_a.values()), list(flat_b.values()))[0]
            print(
                f"extras 15c {mode}: killed after step {RESUME_ABORT} (SIGKILL), resumed at step {at} and run to "
                f"{RESUME_UNTIL}, against an uninterrupted run: bit-equal {checks} (tolerance 0)"
            )
            expect(all(checks.values()) and a["step"] == b["step"] == RESUME_UNTIL, f"15c {mode}: resume differs {checks}")
        print(f"extras 15c: six training processes (DiT-512/2, batch 8 of 4x16x16) in {time.perf_counter() - t0:.1f} s")


def _flat_tensors(tree, prefix: str = "") -> dict:
    import torch

    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_tensors(v, f"{prefix}/{i}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    return out


def _flux_loss(model, x0, noise, sigma, ctx, pooled):
    import torch

    s = sigma[:, None, None, None]
    pred = model((1 - s) * x0 + s * noise, sigma * 1000.0, ctx, pooled, guidance=3.5)
    return torch.mean((pred.float() - (noise - x0)) ** 2)


def _flux_finetune_part(card: str, total: dict[str, int]) -> None:
    """15d: scripts/bench_flux_train.py's configuration: FLUX.1's widths (dim 3072, 24 heads of 128, T5 4096,
    pooled 768) at 2 double + 4 single blocks, bf16 parameters, latent 16x128x128 (4096 image tokens), 512 text
    tokens, batch 1; AdamW8bit(1e-5, cast_updates=False) with stochastic rounding, then a LoRA rank-16 step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skrample_tpu_torch import prng, training
    from skrample_tpu_torch.models.flux import Flux, FluxConfig
    from skrample_tpu_torch.models.lora import jax_leaves, lora_init
    from skrample_tpu_torch.ops import adaln, flash_attention, rope
    from skrample_tpu_torch.optim import AdamW8bit, optimizer_state_bytes, stochastic_round_bf16

    dev = torch.device("cuda")
    config = FluxConfig(
        dim=3072, heads=24, depth=2, single_depth=4, context_dim=4096, pooled_dim=768, guidance=True,
        compute_dtype=torch.bfloat16, attention="flash",
    )
    gen = torch.Generator(dev).manual_seed(15)
    model = Flux(config, device=dev, generator=gen, dtype=torch.bfloat16)
    model.reset_parameters(gen, noise=0.02)
    n_params = sum(p.numel() for p in model.parameters())
    leaves = [leaf.tensor for leaf in jax_leaves(model)]
    print(f"extras 15d: Flux-width fine-tune, {config.depth} double + {config.single_depth} single blocks, {n_params / 1e9:.3f}B parameters (bf16; gains f32)")
    dgen = torch.Generator(dev).manual_seed(16)
    batches = [
        (torch.randn((1, 16, 128, 128), generator=dgen, device=dev), torch.randn((1, 16, 128, 128), generator=dgen, device=dev),
         torch.rand((1,), generator=dgen, device=dev) * 0.998 + 1e-3)
        for _ in range(FLUX_TRAIN_STEPS)
    ]
    ctx = torch.randn((1, 512, 4096), generator=dgen, device=dev)
    pooled = torch.randn((1, 768), generator=dgen, device=dev)
    opt = AdamW8bit(leaves, lr=1e-5, cast_updates=False)
    per = dict.fromkeys(_wrappers(), 0)
    blocks = config.depth + config.single_depth
    per.update(
        flash_attention_qkv_forward_lse=blocks, flash_attention_qkv_backward=blocks,
        rope_qk_norm_forward=2 * config.depth + config.single_depth,
        adaln_forward=4 * config.depth + config.single_depth + 1, adaln_backward=4 * config.depth + config.single_depth + 1,
    )

    def step(i: int):
        opt.zero_grad(set_to_none=True)
        loss = _flux_loss(model, *batches[i % FLUX_TRAIN_STEPS], ctx, pooled)
        loss.backward()
        opt.step(key=prng.fold_in(prng.PRNGKey(0), i))
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    times = []

    def run():
        out = []
        for i in range(FLUX_TRAIN_STEPS):
            t0 = time.perf_counter()
            out.append(step(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out

    losses = _counted_run(
        f"15d Flux-width AdamW8bit + SR, {FLUX_TRAIN_STEPS} steps", {k: v * FLUX_TRAIN_STEPS for k, v in per.items()}, run, total
    )
    losses = torch.stack(losses).tolist()
    peak = torch.cuda.max_memory_allocated()
    print(
        f"extras 15d: losses {', '.join(f'{v:.5f}' for v in losses)}; step times {', '.join(f'{t:.1f}' for t in times)} ms "
        f"(the first with each launcher's setup); peak memory {peak / 2**30:.2f} GiB; optimizer state "
        f"{optimizer_state_bytes(opt.state_dict()) / n_params:.4f} bytes a parameter ({card})"
    )
    expect(all(map(math.isfinite, losses)), f"15d: non-finite loss {losses}")
    t0 = time.perf_counter()
    for i, p in enumerate(leaves):
        if p.dtype == torch.bfloat16:
            stochastic_round_bf16(prng.fold_in(prng.PRNGKey(1), i), p.float())
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    both = (time.perf_counter() - t0) * 1e3
    n_sr = sum(p.dtype == torch.bfloat16 for p in leaves)
    print(f"extras 15d: the stochastic rounding of {n_sr} bf16 leaves: {host:.1f} ms of host time to enqueue, {both:.1f} ms to the card's end")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        step(FLUX_TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_ms, _launches, busy = card_time(prof)
    opt_ms = _optimizer_card_ms(prof, "Optimizer.step#AdamW8bit")
    groups: dict[str, float] = {}
    for name, ms in kernel_ms.items():
        groups[_train_group(name)] = groups.get(_train_group(name), 0.0) + ms
    print(
        f"extras 15d profile: card busy {busy:.1f} ms of a {wall:.1f} ms traced step (idle {100 * (1 - busy / wall):.1f}%); "
        f"the optimizer's range {opt_ms:.1f} ms; by group {{{', '.join(f'{k}: {v:.1f}' for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))}}} ms ({card})"
    )
    # one step's loss and gradients through the kernels against the plain versions (no update)
    plain_versions = (
        (flash_attention, "flash_attention_qkv_forward_lse", flash_attention._qkv_reference_lse),
        (flash_attention, "flash_attention_qkv_backward", flash_attention._qkv_backward_reference),
        (adaln, "adaln_forward", adaln.adaln_reference),
        (adaln, "adaln_backward", adaln.adaln_backward_reference),
        (rope, "rope_qk_norm_forward", _plain_rope),
    )
    del opt
    grads, step_losses = [], []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as patches:
            for module, name, fn in plain_versions if plain else ():
                patches.enter_context(mock.patch.object(module, name, fn))
            loss = _flux_loss(model, *batches[0], ctx, pooled)
            loss.backward()
        torch.cuda.synchronize()
        step_losses.append(loss.item())
        grads.append([p.grad.clone() for p in model.parameters()])
    loss_rel = abs(step_losses[0] - step_losses[1]) / abs(step_losses[1])
    grad_rel = [_relative_fro(a, b) for a, b in zip(*grads)]
    names = [name for name, _ in model.named_parameters()]
    worst = max(range(len(grad_rel)), key=grad_rel.__getitem__)
    print(
        f"extras 15d: kernels vs plain versions, one step: loss {step_losses[0]:.6f} vs {step_losses[1]:.6f}, relative "
        f"{loss_rel:.3e} (tolerance 1e-2); grads relative Frobenius max {grad_rel[worst]:.3e} ({names[worst]}), median "
        f"{statistics.median(grad_rel):.3e} over {len(grad_rel)} tensors (tolerance 5e-2, bf16)"
    )
    expect(loss_rel <= 1e-2 and max(grad_rel) <= 5e-2, f"15d: kernels vs plain: loss {loss_rel}, {names[worst]} {grad_rel[worst]}")
    del grads
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    lora = training.LoRAModel(model, lora_init(prng.PRNGKey(2), model, rank=16))
    adam = training.make_optimizer(lora)
    torch.cuda.reset_peak_memory_stats()
    lora_times = []
    for i in range(2):
        t0 = time.perf_counter()
        adam.zero_grad(set_to_none=True)
        loss = _flux_loss(lora, *batches[i], ctx, pooled)
        loss.backward()
        adam.step()
        torch.cuda.synchronize()
        lora_times.append((time.perf_counter() - t0) * 1e3)
        expect(math.isfinite(loss.item()), "15d: non-finite LoRA loss")
    n_ad = sum(p.numel() for p in lora.parameters())
    print(
        f"extras 15d LoRA rank 16 ({n_ad / 1e6:.2f}M adapter parameters, f32 AdamW): step times "
        f"{', '.join(f'{t:.1f}' for t in lora_times)} ms, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})"
    )


def _vae_loss_part(card: str, total: dict[str, int]) -> None:
    "15e: VAE.loss (SDXL VAE, f32, one 256x256 image) and VideoVAE.loss (phase 10's widths, bf16, 4x128x128)."
    import dataclasses

    import torch

    from skrample_tpu_torch import prng
    from skrample_tpu_torch.models.import_weights import vae_config
    from skrample_tpu_torch.models.vae import VAE
    from skrample_tpu_torch.models.video_vae import VideoVAE, VideoVAEConfig
    from skrample_tpu_torch.ops import fused_conv, groupnorm

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(17)
    sdxl = vae_config(SDXL_VAE_CONFIG)
    image = VAE(sdxl, device=dev, generator=gen)
    image.reset_parameters(gen, noise=0.02)
    video_cfg = VideoVAEConfig(base=64, levels=4, temporal_levels=2, blocks_per_level=2, groups=16, fused_decode=True)
    video = VideoVAE(video_cfg, device=dev, generator=gen)
    video.reset_parameters(gen, noise=0.02)
    cases = (
        ("SDXL VAE f32, (1, 3, 256, 256)", image, sdxl, torch.rand((1, 3, 256, 256), generator=gen, device=dev) * 2 - 1, 1e-3),
        ("VideoVAE bf16, (1, 3, 4, 128, 128)", video, video_cfg,
         torch.rand((1, 3, 4, 128, 128), generator=gen, device=dev) * 2 - 1, 5e-2),
    )
    for label, vae, config, x, grad_tol in cases:
        vae.requires_grad_(True)
        results = {}
        for fused in (True, False):
            vae.config = dataclasses.replace(config, fused_decode=fused)
            vae.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            _reset_counters()
            loss, parts = vae.loss(x, prng.PRNGKey(3))
            loss.backward()
            torch.cuda.synchronize()
            launches = _counters()
            routes = dict(fused_conv.conv3x3_gn_silu_forward.routes)
            for name, count in launches.items():
                total[name] += count
            grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in vae.parameters()]
            times = []
            for _ in range(3):
                vae.zero_grad(set_to_none=True)
                t0 = time.perf_counter()
                vae.loss(x, prng.PRNGKey(3))[0].backward()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            results[fused] = (loss.item(), {k: v.item() for k, v in parts.items()}, grads)
            b12, b13, b8 = (launches["conv3x3_gn_silu_forward"], launches["tconv_causal_gn_silu_forward"], launches["groupnorm_forward"])
            print(
                f"extras 15e {label} {'fused' if fused else 'composition'}: loss {loss.item():.6f} (recon "
                f"{parts['recon'].item():.6f}, kl {parts['kl'].item():.3f}); under training B8 {b8}, B12 {b12} {routes}, "
                f"B13 {b13}; loss + backward median {statistics.median(times):.1f} ms ({card})"
            )
            expect(math.isfinite(loss.item()) and all(bool(torch.isfinite(g).all()) for g in grads), f"15e {label}: not finite")
            if fused:
                expect(b12 > 0 and (b13 > 0 or isinstance(vae, VAE)), f"15e {label}: the fused decode launched B12 {b12}, B13 {b13}")
        vae.config = config
        (lf, _, gf), (lc, _, gc) = results[True], results[False]
        loss_rel = abs(lf - lc) / abs(lc)
        grad_rel = _relative_fro_all(gf, gc)
        print(
            f"extras 15e {label}: fused vs composition, loss relative {loss_rel:.3e} (tolerance 1e-3), gradients "
            f"relative Frobenius {grad_rel:.3e} over all {len(gf)} tensors (tolerance {grad_tol:g})"
        )
        expect(loss_rel <= 1e-3 and grad_rel <= grad_tol, f"15e {label}: fused vs composition {loss_rel}, {grad_rel}")
        vae.requires_grad_(False)
    del image, video


def _flux_head_dims_part(card: str, total: dict[str, int]) -> None:
    """15f (C13): a Flux at FLUX.1's widths (dim 3072, T5 4096, pooled 768; 1 double + 2 single blocks) with
    heads of 64 (48 heads; ``"flash"``: B10's body on the qkv's chunk(3) views; and ``"full"``) and of 96 (32
    heads, ``"full"``; B7's run-time-d body), one 1024x1024 forward each against the plain versions."""
    import torch

    from skrample_tpu_torch.models.flux import Flux, FluxConfig
    from skrample_tpu_torch.ops import adaln, flash_attention, rope

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(18)
    x = torch.randn((1, 16, 128, 128), generator=gen, device=dev)
    ctx = torch.randn((1, 512, 4096), generator=gen, device=dev)
    pooled = torch.randn((1, 768), generator=gen, device=dev)
    t = torch.tensor([600.0], device=dev)
    for heads, axes, attention, key, route in (
        (48, (16, 24, 24), "flash", "rope_qk_norm_forward d64", "d64"),
        (48, (16, 24, 24), "full", "rope_qk_norm_forward d64", "d64"),
        (32, (16, 40, 40), "full", "rope_qk_norm_forward d96", "run-time d"),
    ):
        config = FluxConfig(
            dim=3072, heads=heads, depth=1, single_depth=2, context_dim=4096, pooled_dim=768, rope_axes=axes,
            guidance=True, compute_dtype=torch.bfloat16, attention=attention,
        )
        model = Flux(config, device=dev, generator=gen, dtype=torch.bfloat16)
        model.reset_parameters(gen, noise=0.02)
        model.requires_grad_(False)
        want = dict.fromkeys(_wrappers(), 0)
        want.update(
            adaln_forward=4 * config.depth + config.single_depth + 1,
            rope_qk_norm_forward=2 * config.depth + config.single_depth,
            flash_attention_pairs_forward=(config.depth + config.single_depth) if attention == "flash" else 0,
        )
        label = f"15f Flux head dim {config.head_dim} attention={attention!r}"
        with torch.inference_mode():
            got = _counted_run(label, want, lambda model=model: model(x, t, ctx, pooled, guidance=3.5), total)
            on_route = rope.rope_qk_norm_forward.routes[route]
            total[key] += on_route
            with (
                mock.patch.object(flash_attention, "flash_attention_pairs_forward", flash_attention._packed_reference),
                mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
                mock.patch.object(rope, "rope_qk_norm_forward", _plain_rope),
            ):
                plain = model(x, t, ctx, pooled, guidance=3.5)
        rel = max_err(got, plain) / max(plain.abs().max().item(), 1e-12)
        print(
            f"extras {label}: B7 {on_route} launches on its {route} route; against the plain versions max abs err "
            f"relative {rel:.3e} (tolerance 5e-2, bf16)"
        )
        expect(bool(torch.isfinite(got).all()) and rel <= 5e-2 and on_route == want["rope_qk_norm_forward"], f"{label}: {rel}, {on_route}")
        del model


def sd3_kernels(gen) -> dict[str, dict]:
    """B10 and B7 at SD3.5-large's joint shape under CFG (batch 2): 4096 image + 77 CLIP + 256 T5 = 4429
    tokens (ragged: not a multiple of 128), 38 heads of 64; B10 on the chunk(3) views of a joint qkv, B7
    with identity tables (the MMDiT's qk-norm: cos 1, sin 0), in place.  Each against its plain version
    (5e-2 of its largest value), with times and bounds."""
    import torch
    import torch.nn.functional as F

    from skrample_tpu_torch.ops import flash_attention, rope

    dev = torch.device("cuda")
    rows: dict[str, dict] = {}
    B, N, H, d = 2, SD3_TOKENS, 38, 64

    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    views = qkv.chunk(3, dim=-1)
    got = flash_attention.flash_attention_pairs_forward(*views, H)
    ref = flash_attention._packed_reference(*views, H)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    rel = err / ref.abs().max().item()
    print(
        f"B10 flash_attention_pairs_forward bf16 chunk(3) views of {tuple(qkv.shape)} (SD3.5-large joint, CFG): "
        f"max_abs_err {err:.3e}, {rel:.3e} of the largest output (tolerance 5e-2)"
    )
    expect(bool(torch.isfinite(got).all()) and rel <= 5e-2, f"B10 at the SD3.5 shape disagrees: {rel}")
    q, k, v = (t.view(B, N, H, d).transpose(1, 2) for t in views)
    b_ms, b_by = bound_ms((qkv.numel() + got.numel()) * 2, 4 * B * H * N * N * d, PEAK_BF16_FLOPS)
    timing: dict = {}
    timed(timing, "ms", lambda: flash_attention.flash_attention_pairs_forward(*views, H))
    timed(timing, "plain_ms", lambda: flash_attention._packed_reference(*views, H), iters=3)
    timed(timing, "library_ms", lambda: F.scaled_dot_product_attention(q, k, v))
    rows["flash_attention_pairs_forward sd3.5"] = {
        "name": "flash_attention_pairs_forward sd3.5",
        "route": "cuda",
        "source": "skrample_tpu_torch/csrc/flash_attention_sm90.cu",
        "replaces": "skrample_tpu/ops/flash_attention.py:798",
        "max_abs_err": err,
        "bound_ms": b_ms,
        "bound_by": b_by,
        **timing,
    }
    del qkv, views, got, ref, q, k, v

    qkv = (torch.randn((B, N, 3 * H * d), generator=gen, device=dev) * 2).to(torch.bfloat16)
    gq, gk = (1 + 0.1 * torch.randn(d, generator=gen, device=dev) for _ in range(2))
    cos, sin = torch.ones((N, d // 2), device=dev), torch.zeros((N, d // 2), device=dev)
    want = rope.rope_qk_norm_reference(qkv, gq, gk, cos, sin, H)
    inplace = rope.rope_qk_norm_forward(qkv.clone(), gq, gk, cos, sin, H, in_place=True)
    torch.cuda.synchronize()
    err = max_err(inplace, want)
    scale = want.float().abs().max().item()
    ulps = _ulps_bf16(inplace, want)
    print(
        f"B7 rope_qk_norm_forward bf16 {tuple(qkv.shape)} with identity tables (SD3.5-large's qk-norm), in place: "
        f"max_abs_err {err:.3e}, {err / scale:.3e} of the largest output (tolerance 5e-2), at most {ulps:g} bf16 ulp"
    )
    expect(bool(torch.isfinite(inplace).all()) and err <= 5e-2 * scale, f"B7 at the SD3.5 shape disagrees: {err}")
    qk_bytes = B * N * 2 * H * d * 2
    b_ms, b_by = bound_ms(2 * qk_bytes + 2 * cos.numel() * 4 + 2 * d * 4, 8 * B * N * 2 * H * d, PEAK_F32_FLOPS)
    args = (qkv, gq, gk, cos, sin, H)
    timing = {}
    timed(timing, "ms", lambda: rope.rope_qk_norm_forward(*args, in_place=True))
    timed(timing, "plain_ms", lambda: rope.rope_qk_norm_reference(*args))
    rows["rope_qk_norm_forward sd3.5"] = {
        "name": "rope_qk_norm_forward sd3.5",
        "route": "cuda",
        "source": "skrample_tpu_torch/csrc/rope.cu",
        "replaces": "skrample_tpu/ops/rope.py:94",
        "max_abs_err": err,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        **timing,
    }
    return rows


# stabilityai/stable-diffusion-3.5-large: transformer/config.json (38 layers, 38 heads of 64, joint_attention_dim
# 4096, pooled_projection_dim 2048, pos_embed_max_size 192, qk_norm rms_norm); stable-diffusion-3.5-medium's: 24
# layers, 24 heads, dual_attention_layers 0-12, pos_embed_max_size 384.  context_tokens is only the FLOP count's text
# length under the SD3 wiring: CLIP's 77 + T5's 256.
SD35_LARGE = {
    "dim": 2432, "depth": 38, "heads": 38, "patch": 2, "channels": 16, "context_dim": 4096, "context_tokens": 333,
    "pooled_dim": 2048, "pos_embed_max": 192, "qk_norm": True, "final_txt_pre_only": True,
}
SD35_MEDIUM = {
    **SD35_LARGE, "dim": 1536, "depth": 24, "heads": 24, "pos_embed_max": 384, "dual_attention_layers": tuple(range(13)),
}
# text_encoder / text_encoder_2 / text_encoder_3 config.json: CLIP-L, OpenCLIP bigG, the T5-XXL v1.1 encoder
CLIP_L_CONFIG = {
    "vocab_size": 49408, "dim": 768, "depth": 12, "heads": 12, "mlp_ratio": 4, "max_tokens": 77, "causal": True,
    "ln_affine": True, "ln_eps": 1e-5, "act": "quick_gelu", "eos_id": 49407,
}
CLIP_G_CONFIG = {**CLIP_L_CONFIG, "dim": 1280, "depth": 32, "heads": 20, "act": "gelu"}
T5_XXL_CONFIG = {
    "vocab_size": 32128, "dim": 4096, "head_dim": 64, "heads": 64, "ff_dim": 10240, "depth": 24, "gated": True,
    "rel_buckets": 32, "rel_max_distance": 128,
}
SD3_VAE_CONFIG = {  # vae/config.json: 16 latent channels, no quant convs
    **SDXL_VAE_CONFIG, "latent_channels": 16, "scaling_factor": 1.5305, "shift_factor": 0.0609, "use_quant_conv": False,
}
SD3_PROMPTS = ("a photograph of an astronaut riding a horse on mars", "a watercolor painting of a red fox in the snow")
SD3_GROUPS = (
    ("K1 fused_step", ("fused_step_kernel",)),
    ("B10 flash_pairs", ("flash_strided_sm90_kernel",)),
    ("K3 adaln", ("adaln_kernel",)),
    ("B7 rope_qk_norm", ("rope_qk_norm_kernel",)),
    ("B12 convs", B12_KERNELS),
    ("B8 groupnorm", B8_KERNELS),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
)


def _synthetic_tokenizers():
    """The CLIP BPE and the T5 Unigram tokenizers over vocabularies built here (real vocabularies are
    checkpoint assets): every byte and the prompts' words as merges, the specials at CLIP's ids 49406/49407;
    the prompts' words and single letters as scored pieces for T5 (pad 0, eos 1, unk 2)."""
    from skrample_tpu_torch.models.tokenizers import CLIPBPETokenizer, UnigramTokenizer, _bytes_to_unicode

    words = sorted({w for p in SD3_PROMPTS for w in p.split()})
    table = _bytes_to_unicode()
    vocab: dict[str, int] = {}
    for b in range(256):
        vocab.setdefault(table[b], len(vocab))
        vocab.setdefault(table[b] + "</w>", len(vocab))
    merges: list[tuple[str, str]] = []
    for word in words:
        pieces = [*word[:-1], word[-1] + "</w>"]
        while len(pieces) > 1:
            pair = (pieces[0], pieces[1])
            if pair not in merges:
                merges.append(pair)
                vocab.setdefault(pair[0] + pair[1], len(vocab))
            pieces = [pair[0] + pair[1], *pieces[2:]]
    vocab.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    scored = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -4.0)]
    scored += [(f"▁{w}", -2.0 - 0.01 * i) for i, w in enumerate(words)]
    scored += [(chr(c), -8.0) for c in range(ord("a"), ord("z") + 1)]
    return CLIPBPETokenizer(vocab, merges), UnigramTokenizer(scored, max_tokens=256)


class _DenseShapes:
    """Records the dense products' shapes while active: ``(rows, d_in, d_out, dtype, route)`` of every
    ``aten.addmm`` with a 1-D bias and 16-bit operands; route ``"epilogue"`` for the one-pass product
    (``aten.addmm.default``, ROADMAP C6's route), ``"two-pass"`` for the float32 sum (``aten.addmm.dtype``)."""

    def __init__(self) -> None:
        self.shapes: set[tuple] = set()

    def __call__(self, run):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        shapes = self.shapes

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func in (torch.ops.aten.addmm.default, torch.ops.aten.addmm.dtype):
                    bias, x, wt = args[:3]
                    if bias.dim() == 1 and x.dtype in (torch.bfloat16, torch.float16):
                        route = "epilogue" if func is torch.ops.aten.addmm.default else "two-pass"
                        shapes.add((x.shape[0], x.shape[1], wt.shape[1], x.dtype, route))
                return func(*args, **(kwargs or {}))

        with Mode():
            return run()


def _epilogue_check(
    shapes: set, graphed: dict | None, label: str = "sd3 16e", over: str = "phases 3, 6, 7 and 16's models"
) -> None:
    """16e (ROADMAP C6): at every recorded dense shape, ``torch.addmm(b, x, wᵀ)`` with the bias in the compute
    dtype (cuBLASLt's bias epilogue) against ``_dense_forward``'s two passes on the same random operands,
    bit for bit; then phase 14's graphed DiT request time and its copy kernels beside those before the repair
    (PERF.md: 34.83 ms, 24.21 busy, the bf16 copy kernel 6.1 ms)."""
    import torch

    from skrample_tpu_torch.models.dit import _dense_forward

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(16)
    unique = sorted({shape[:4] for shape in shapes}, key=str)
    routes = {route: sorted({s[:4] for s in shapes if s[4] == route}, key=str) for route in ("epilogue", "two-pass")}
    differ = []
    for rows, d_in, d_out, dtype in unique:
        x = torch.randn((rows, d_in), generator=gen, device=dev).to(dtype)
        w = (torch.randn((d_out, d_in), generator=gen, device=dev) / d_in**0.5).to(dtype)
        b = (torch.randn(d_out, generator=gen, device=dev) * 0.1).to(dtype)
        if not torch.equal(torch.addmm(b, x, w.t()), _dense_forward(x, w, b)):
            differ.append((rows, d_in, d_out, dtype))
    print(
        f"{label}: {len(unique)} dense shapes over {over}; served on the epilogue route "
        f"{len(routes['epilogue'])}, on the two passes {len(routes['two-pass'])} (float32 biases); the epilogue "
        f"differs from the two passes at {len(differ)} shapes: {differ}"
    )
    print(f"{label}: epilogue-route shapes (rows, d_in, d_out, dtype): {routes['epilogue']}")
    expect(bool(routes["epilogue"]) and bool(routes["two-pass"]), f"{label}: recorded no shape on a route: {routes}")
    expect(not differ, f"{label}: the epilogue route differs from the two passes at {differ}")
    if graphed:
        copies = {name: ms for name, ms in graphed["kernel_ms"].items() if "copy" in name.lower()}
        bf16_copy = sum(ms for name, ms in copies.items() if "bfloat16_copy_kernel" in name)
        print(
            f"sd3 16e: phase 14's graphed DiT-512/8 request: median {graphed['median_ms']:.2f} ms (before C6: 34.83), "
            f"card busy {graphed['busy_ms']:.2f} ms (24.21); the bf16 copy kernel {bf16_copy:.3f} ms of it (6.1), every "
            f"kernel named a copy {sum(copies.values()):.3f} ms in {len(copies)} kernels"
        )


def _record_earlier_shapes(recorder: _DenseShapes, parts: dict) -> None:
    """16e's shapes of phases 3 and 14 (DiT-512/8 at buckets 1, 2, 4), 6 (FLUX.1-dev's widths, one double and
    one single block: every dense shape of the 19 + 38, at batch 1 and 2) and 7 (the SDXL UNet's CFG forward at
    buckets 1 and 2)."""
    import torch

    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.models.flux import Flux, FluxConfig
    from skrample_tpu_torch.models.sdxl import SDXLStack

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(15)
    config = DiTConfig(dim=512, depth=DEPTH, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash")
    dit = DiT(config, device=dev).load_jax_params(random_param_tree(config, seed=0)).requires_grad_(False)
    flux_config = FluxConfig(
        dim=3072, heads=24, depth=1, single_depth=1, context_dim=4096, pooled_dim=768, guidance=True,
        compute_dtype=torch.bfloat16, attention="flash",
    )
    flux = Flux(flux_config, device=dev, generator=gen, dtype=torch.bfloat16).requires_grad_(False)
    unet_fn = None  # phase 16 run alone has no phase-7 UNet
    if "unet" in parts:
        time_ids = SDXLStack.time_ids((1024, 1024), (0, 0), (1024, 1024), device=dev)
        unet_fn = SDXLStack(parts["unet"]).as_served(time_ids, 5.0, parts["uncond"])
    t = torch.tensor(500.0, device=dev)
    with torch.inference_mode():
        for b in (1, 2, 4):
            recorder(lambda b=b: dit(torch.randn((b, 4, 64, 64), generator=gen, device=dev), t))
        for b in (1, 2):
            ctx = torch.randn((b, 512, 4096), generator=gen, device=dev)
            pooled = torch.randn((b, 768), generator=gen, device=dev)
            x = torch.randn((b, 16, 128, 128), generator=gen, device=dev)
            recorder(lambda x=x, ctx=ctx, pooled=pooled: flux(x, t, ctx, pooled, guidance=3.5))
            if unet_fn is not None:
                cond = tuple(torch.stack([part] * b) for part in parts["contexts"][0])
                x = torch.randn((b, 4, 128, 128), generator=gen, device=dev)
                recorder(lambda x=x, cond=cond: unet_fn(x, t, None, None, cond))
    torch.cuda.synchronize()


def _mmdit_per_forward(config) -> dict[str, int]:
    """Launches of one MMDiT forward: K3 4 a block (3 for the pre-only last) + 1 a dual attention + the final
    one (on the card K3 takes the text stream's 333 tokens too); B7 2 a block + 1 a dual attention; B10 1 a
    block + 1 a dual attention."""
    dual = len(config.dual_attention_layers)
    per = dict.fromkeys(_wrappers(), 0)
    per.update(
        adaln_forward=4 * config.depth - int(config.final_txt_pre_only) + dual + 1,
        rope_qk_norm_forward=(2 * config.depth + dual) if config.qk_norm else 0,
        flash_attention_pairs_forward=config.depth + dual,
    )
    return per


def _plain_kernels():
    "The MMDiT's kernels swapped for their plain versions (B10, K3, B7)."
    from skrample_tpu_torch.ops import adaln, flash_attention, rope

    return (
        mock.patch.object(flash_attention, "flash_attention_pairs_forward", flash_attention._packed_reference),
        mock.patch.object(adaln, "adaln_forward", adaln.adaln_reference),
        mock.patch.object(rope, "rope_qk_norm_forward", _plain_rope),
    )


def sd3_phase(card: str, parts: dict, graphed: dict | None) -> dict[str, int]:
    """Phase 16: A3 with SD3's text path at SD3.5-large's widths, on random weights drawn on the card.  (a) Prompts
    tokenized by ``CLIPBPETokenizer``/``UnigramTokenizer`` (synthetic vocabularies), encoded by CLIP-L, CLIP-G and
    the T5-XXL encoder (``SD3Stack.encode_prompt``), served by ``ServingEngine(stack.as_served(4.5, uncond),
    conditioned=True, postprocess=stack.decode)`` over the MMDiT (38 blocks of 2432, bf16) and the SD3 VAE (f32):
    Euler over FlowShift(Linear) at shift 3.0, 10 steps (SD3's 28 cut), 1024x1024; 3 requests (2 together, then
    the first alone, equal to its packed twin bit for bit), exact launches by kernel and route, finite pixels,
    the median latency, the card's busy share over a traced request.  (b) One forward through the kernels
    against the plain versions (5e-2).  (c) The int8 model: one forward, cosine > 0.99 to (b)'s, B6 counted.
    (d) SD3.5-medium's widths (24 blocks of 1536, dual attention 0-12): one forward against the plain versions,
    B10 on both attentions.  (e) C6: the epilogue route against the two passes, bit for bit, at every dense shape
    of phases 3, 6, 7 and 16; phase 14's graphed request beside its numbers before the repair.  Returns the main
    path's launches."""
    import gc

    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.import_weights import vae_config
    from skrample_tpu_torch.models.mmdit import MMDiT, MMDiTConfig, mmdit_forward_flops
    from skrample_tpu_torch.models.sd3 import SD3Stack
    from skrample_tpu_torch.models.t5_encoder import T5Encoder, T5EncoderConfig
    from skrample_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
    from skrample_tpu_torch.models.vae import VAE, fused_convs_per_decode
    from skrample_tpu_torch.ops import fused_conv, quant, rope
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    recorder = _DenseShapes()
    _record_earlier_shapes(recorder, parts)
    parts.clear()  # phase 7's UNet: the SD3.5-large stack needs the room
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sd3 16e: {len(recorder.shapes)} dense shapes recorded over phases 3, 6 and 7's models; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the SD3.5 stack")

    # ---- (a) the SD3.5-large stack on the card ----
    gen = torch.Generator(dev).manual_seed(160)
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    config = MMDiTConfig(**SD35_LARGE, compute_dtype=bf16, attention="flash")
    mmdit = MMDiT(config, device=dev, generator=gen, dtype=bf16)
    mmdit.reset_parameters(gen, noise=0.02)  # Flux's recipe: adaLN-zero would make every output exactly 0
    clip_l = TextEncoder(TextEncoderConfig(**CLIP_L_CONFIG, compute_dtype=bf16), device=dev, generator=gen, dtype=bf16)
    clip_g = TextEncoder(TextEncoderConfig(**CLIP_G_CONFIG, compute_dtype=bf16), device=dev, generator=gen, dtype=bf16)
    t5 = T5Encoder(T5EncoderConfig(**T5_XXL_CONFIG, compute_dtype=bf16), device=dev, generator=gen, dtype=bf16)
    vae_cfg = vae_config(SD3_VAE_CONFIG)
    vae = VAE(vae_cfg, device=dev, generator=gen)
    vae.reset_parameters(gen, noise=0.02)
    for module in (mmdit, clip_l, clip_g, t5, vae):
        module.requires_grad_(False)
    stack = SD3Stack(mmdit, vae, clip_l, clip_g, t5, t5_tokens=256)
    torch.cuda.synchronize()
    counts = {name: sum(p.numel() for p in m.parameters()) for name, m in
              (("MMDiT", mmdit), ("CLIP-L", clip_l), ("CLIP-G", clip_g), ("T5-XXL", t5), ("VAE", vae))}
    print(
        f"sd3: SD3.5-large widths drawn on the card in {time.perf_counter() - t0:.1f} s: "
        f"{', '.join(f'{k} {v / 1e9:.3f}B' for k, v in counts.items())} parameters (bf16; the VAE f32); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated"
    )
    clip_tok, t5_tok = _synthetic_tokenizers()

    def encode(prompts) -> tuple:
        "Text to (context, pooled): CLIP-L pads with its EOS, CLIP-G with 0 (SD3's tokenizer_2), T5 to 256 tokens."
        return stack.encode_prompt(clip_tok(prompts), clip_tok(prompts, pad_id=0), t5_tok(prompts, length=256))

    item_shape = (16, 128, 128)  # 1024x1024 through the VAE's factor 8
    per_forward = _mmdit_per_forward(config)
    per_decode = fused_convs_per_decode(vae_cfg)
    flops = mmdit_forward_flops(config, 1, 128, 128)
    zgen = torch.Generator(dev).manual_seed(161)
    with torch.inference_mode():  # warm-up: both buckets' CFG forwards (recorded for 16e), the text towers, decodes
        uncond = recorder(lambda: encode([""]))
        warm = recorder(lambda: encode(list(SD3_PROMPTS)))
        served = stack.as_served(SD3_GUIDANCE, uncond)
        for b in (1, 2):
            x = torch.randn((b, *item_shape), generator=zgen, device=dev)
            recorder(lambda b=b, x=x: served(x, torch.tensor(500.0, device=dev), None, None, (warm[0][:b], warm[1][:b])))
            stack.decode(x)
        torch.cuda.synchronize()
    engine = ServingEngine(
        served, item_shape=item_shape, sampler=structured.Euler(),
        schedule=scheduling.FlowShift(scheduling.Linear(), shift=3.0), model_transform=models.FlowModel(),
        steps=SD3_STEPS, dtype=torch.float32, buckets=(1, 2), conditioned=True, device=dev, postprocess=stack.decode,
    )
    with engine:
        # the main path: text ids to pixels, requests A and B together, then A again alone
        torch.cuda.reset_peak_memory_stats()
        batches_before = engine.stats.batches
        torch.cuda.synchronize()
        _reset_counters()
        d64_before = rope.rope_qk_norm_forward.routes["d64"]
        t0 = time.perf_counter()
        with torch.inference_mode():
            ctx, pooled = encode(list(SD3_PROMPTS))
        encode_s = time.perf_counter() - t0
        requests = [(1, (ctx[0], pooled[0])), (2, (ctx[1], pooled[1]))]
        futs = [engine.submit(seed, context=c) for seed, c in requests]
        outs = [f.result().cpu() for f in futs]
        pair_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs.append(engine.generate(requests[0][0], context=requests[0][1]).cpu())
        solo_s = [time.perf_counter() - t0]
        torch.cuda.synchronize()
        launches = _counters()
        d64 = rope.rope_qk_norm_forward.routes["d64"] - d64_before
        f32_convs = _routes()["conv3x3_gn_silu_forward"]["f32"]
        peak = torch.cuda.max_memory_allocated()
        dispatches = engine.stats.batches - batches_before
        forwards = SD3_STEPS * dispatches
        want = {name: n * forwards for name, n in per_forward.items()}
        want.update(fused_step_cuda=forwards, conv3x3_gn_silu_forward=per_decode * dispatches, groupnorm_forward=dispatches)
        print(f"sd3 16a: 2 prompts encoded (CLIP-L, CLIP-G, T5-XXL) in {encode_s * 1e3:.1f} ms; 3 requests in "
              f"{dispatches} dispatches ({engine.stats.bucket_counts}); launches {launches} (expected {want})")
        print(f"sd3 16a: attention launches by route: {_attention_routes()}; B7 on its d64 route {d64}; B12 on its "
              f"f32 route {f32_convs}")
        expect(dispatches == 2 and launches == want, f"sd3 16a: launches {launches}, expected {want}")
        expect(d64 == want["rope_qk_norm_forward"] and f32_convs == want["conv3x3_gn_silu_forward"],
               f"sd3 16a: B7 d64 {d64}, B12 f32 {f32_convs}")
        for o in outs:
            expect(tuple(o.shape) == (3, 1024, 1024) and bool(torch.isfinite(o).all()), f"sd3 16a: bad pixels {o.shape}")
        same = torch.equal(outs[2], outs[0])
        print(
            f"sd3 16a: pixels (3, 1024, 1024) finite, range [{outs[0].min().item():.3f}, {outs[0].max().item():.3f}]; "
            f"request A alone == A packed, bit for bit: {same}"
        )
        expect(same, f"sd3 16a: packing changes request A's pixels by {_relative(outs[2], outs[0])}")
        for name, count in launches.items():
            total[name] += count
        total["flash_attention_pairs_forward sd3.5"] = launches["flash_attention_pairs_forward"]
        total["rope_qk_norm_forward sd3.5"] = d64
        print(f"sd3 16a: after the main path, {_clocks()}")

        for i in range(2):
            t0 = time.perf_counter()
            engine.generate(500 + i, context=requests[0][1]).cpu()
            solo_s.append(time.perf_counter() - t0)
        solo = statistics.median(solo_s)
        print(
            f"sd3 16a: request latency ({SD3_STEPS} CFG steps and the decode; the prompt encoded before), bucket 1: "
            f"median {solo * 1e3:.1f} ms "
            f"of {len(solo_s)} ({', '.join(f'{v * 1e3:.1f}' for v in solo_s)}); the pair {pair_s * 1e3:.1f} ms with the "
            f"encode; {2 * flops * SD3_STEPS / solo / 1e12:.1f} TFLOP/s of MMDiT products; peak {peak / 2**30:.2f} GiB ({card})"
        )
        _traced_dispatch(
            lambda: engine.generate(700, context=requests[0][1]).cpu(), "sd3 bucket 1", solo, card, SD3_GROUPS,
            share="B10 flash_pairs",
        )
    del engine, served, clip_l, clip_g, t5, stack
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) one forward at batch 1 through the kernels, then through the plain versions ----
    fgen = torch.Generator(dev).manual_seed(162)
    x = torch.randn((1, *item_shape), generator=fgen, device=dev)
    args = (x, torch.tensor(500.0, device=dev), ctx[:1], pooled[:1])
    with torch.inference_mode():
        _reset_counters()
        got = mmdit(*args)
        kernel_counts = _counters()
        with contextlib.ExitStack() as plain:
            for patch in _plain_kernels():
                plain.enter_context(patch)
            want_out = mmdit(*args)
        torch.cuda.synchronize()
    expect(kernel_counts == per_forward, f"sd3 16b: one forward launched {kernel_counts}, expected {per_forward}")
    expect(_counters() == kernel_counts, f"sd3 16b: the plain forward launched kernels: {_counters()}")
    vs_plain = _relative(got, want_out)
    print(f"sd3 16b: SD3.5-large, one forward through the kernels vs the plain versions: relative max err {vs_plain:.3e} "
          f"(tolerance 5e-2)")
    expect(bool(torch.isfinite(want_out).all()) and vs_plain <= 5e-2, f"sd3 16b: kernel forward differs by {vs_plain}")

    # ---- (c) the int8 model: one forward, B6 in front of each int8 product ----
    t0 = time.perf_counter()
    int8 = mmdit.quantize_params()
    torch.cuda.synchronize()
    n_int8 = sum(isinstance(m, quant.Int8Dense) for m in int8.modules())
    with torch.inference_mode():
        _reset_counters()
        q_out = int8(*args)
        torch.cuda.synchronize()
        q_counts = _counters()
    want_q = dict(per_forward, quantize_rows=n_int8)
    cosine = _cosine(q_out, got)
    print(f"sd3 16c: int8 SD3.5-large quantized in {time.perf_counter() - t0:.1f} s ({n_int8} int8 layers); one forward "
          f"launched {q_counts}; cosine to 16b's bf16 output {cosine:.6f} (> 0.99)")
    expect(n_int8 == 8 * config.depth - 3 + 2 and q_counts == want_q, f"sd3 16c: {n_int8} int8 layers, launches {q_counts}")
    expect(bool(torch.isfinite(q_out).all()) and cosine > 0.99, f"sd3 16c: cosine {cosine}")
    for name, count in q_counts.items():
        total[name] += count
    del int8, mmdit, q_out
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) SD3.5-medium's widths: dual attention in blocks 0-12 ----
    m_config = MMDiTConfig(**SD35_MEDIUM, compute_dtype=bf16, attention="flash")
    medium = MMDiT(m_config, device=dev, generator=gen, dtype=bf16)
    medium.reset_parameters(gen, noise=0.02)
    medium.requires_grad_(False)
    m_per_forward = _mmdit_per_forward(m_config)
    with torch.inference_mode():
        recorder(lambda: medium(torch.cat([x, x]), args[1], torch.cat([ctx[:1], uncond[0]]), torch.cat([pooled[:1], uncond[1]])))
        _reset_counters()
        got = medium(*args)
        m_counts = _counters()
        with contextlib.ExitStack() as plain:
            for patch in _plain_kernels():
                plain.enter_context(patch)
            want_out = medium(*args)
        torch.cuda.synchronize()
    vs_plain = _relative(got, want_out)
    print(
        f"sd3 16d: SD3.5-medium widths ({sum(p.numel() for p in medium.parameters()) / 1e9:.3f}B, dual attention in "
        f"{len(m_config.dual_attention_layers)} blocks): one forward launched {m_counts} (B10 on both attentions: "
        f"{m_per_forward['flash_attention_pairs_forward']}); against the plain versions relative max err {vs_plain:.3e} "
        f"(tolerance 5e-2)"
    )
    expect(m_counts == m_per_forward, f"sd3 16d: one forward launched {m_counts}, expected {m_per_forward}")
    expect(bool(torch.isfinite(got).all()) and vs_plain <= 5e-2, f"sd3 16d: kernel forward differs by {vs_plain}")
    for name, count in m_counts.items():
        total[name] += count
    del medium, got, want_out
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) ROADMAP C6: every recorded dense shape, the epilogue against the two passes ----
    _epilogue_check(recorder.shapes, graphed)
    print(f"sd3: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


# diffusers/controlnet-canny-sdxl-1.0 config.json (the fields the importer reads): SDXL base's encoder and the
# published conditioning ladder over a 3-channel control image
CONTROLNET_SDXL_CONFIG = {
    "in_channels": 4, "block_out_channels": (320, 640, 1280),
    "down_block_types": ("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"), "layers_per_block": 2,
    "transformer_layers_per_block": [1, 2, 10], "attention_head_dim": [5, 10, 20], "cross_attention_dim": 2048,
    "norm_num_groups": 32, "addition_embed_type": "text_time", "addition_time_embed_dim": 256,
    "projection_class_embeddings_input_dim": 2816, "flip_sin_to_cos": True, "freq_shift": 0,
    "conditioning_channels": 3, "conditioning_embedding_out_channels": (16, 32, 96, 256),
}
# black-forest-labs/FLUX.1-dev vae/config.json: 16 latent channels, its scale and shift, no quant convs
FLUX_VAE_CONFIG = {
    **SDXL_VAE_CONFIG, "latent_channels": 16, "scaling_factor": 0.3611, "shift_factor": 0.1159, "use_quant_conv": False,
}
FLUX_STACK_STEPS = 10  # phase 17 cuts FLUX.1-dev's 28 steps to keep the phase within its time: the stack is new
FLUX_T5_TOKENS = 512  # FLUX.1-dev's max_sequence_length
TRACE_STEPS = 5  # 17a traces a request cut to 5 of its 25 steps: the profiler takes minutes over a whole one


def _sdxl_base(parts: dict) -> tuple:
    """Phase 7's UNet and prompt features, or, where phase 17 runs alone, the same build: SDXL base bf16 with
    every leaf random, two prompts' features and the empty prompt's."""
    import torch

    from skrample_tpu_torch.models.unet_cond import CondUNet, CondUNetConfig

    if "unet" in parts:
        return parts["unet"], parts["contexts"], parts["uncond"]
    dev = torch.device("cuda")
    config = CondUNetConfig(compute_dtype=torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(0)
    unet = CondUNet(config, device=dev, generator=gen, dtype=torch.bfloat16)
    unet.reset_parameters(gen, noise=0.02)
    unet.requires_grad_(False)
    cgen = torch.Generator(dev).manual_seed(1)

    def features() -> tuple:
        return (torch.randn((77, config.context_dim), generator=cgen, device=dev),
                torch.randn((config.pooled_dim,), generator=cgen, device=dev))

    return unet, [features(), features()], features()


def _controlnet_part(card: str, parts: dict, recorder, total: dict[str, int]) -> tuple:
    """17a: ControlNet over SDXL base; returns the UNet, the CFG forward's inputs and its bf16 output for 17b."""
    import dataclasses
    import gc

    import torch

    from skrample_tpu_torch.models.controlnet import ControlNet
    from skrample_tpu_torch.models.import_weights import diffusers_controlnet, vae_config
    from skrample_tpu_torch.models.sdxl import SDXLStack
    from skrample_tpu_torch.models.vae import VAE, fused_convs_per_decode
    from skrample_tpu_torch.ops import flash_attention, fused_conv, groupnorm

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    # ---- the importer at full width: a synthetic diffusers-keyed state dict, then a bf16 module on the card ----
    sys.path.insert(0, str(ROOT / "tests"))
    from diffusers_state_dicts import unet_state_dict  # the CPU tests' synthetic state dicts, numpy only

    t0 = time.perf_counter()
    sd = unet_state_dict(CONTROLNET_SDXL_CONFIG, None, controlnet=True)  # zeros: drawn on the card after the import
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cn_config, tree = diffusers_controlnet((sd, CONTROLNET_SDXL_CONFIG))
    import_s = time.perf_counter() - t0
    n_keys, n_values = len(sd), sum(a.size for a in sd.values())
    u = cn_config.unet
    expect(
        (u.widths, u.transformer_layers, u.heads, u.context_dim, u.pooled_dim, cn_config.cond_embed_channels)
        == ((320, 640, 1280), (0, 2, 10), (5, 10, 20), 2048, 1280, (16, 32, 96, 256)),
        f"controlnet 17a: the imported configuration {cn_config}",
    )
    cn_config = dataclasses.replace(cn_config, unet=dataclasses.replace(u, compute_dtype=bf16))
    gen = torch.Generator(dev).manual_seed(170)
    t0 = time.perf_counter()
    cn = ControlNet(cn_config, device=dev, generator=gen, dtype=bf16).load_jax_params(tree)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del sd, tree
    gc.collect()
    cn.reset_parameters(gen, noise=0.02)  # random weights: the zero convs would otherwise make every residual 0
    cn.requires_grad_(False)
    n_params = sum(p.numel() for p in cn.parameters())
    print(
        f"controlnet 17a: diffusers_controlnet at controlnet-canny-sdxl-1.0's widths: {n_keys} state-dict keys, "
        f"{n_values / 1e9:.3f}B values ({n_values * 4 / 2**30:.2f} GiB f32), made in {made_s:.1f} s, imported in "
        f"{import_s:.1f} s of host time; loaded into a bf16 ControlNet on the card in {load_s:.1f} s; "
        f"{n_params / 1e9:.3f}B parameters (the fused projections' zero biases added) drawn on the card (standard "
        f"init + 0.02 N(0, 1))"
    )

    unet, contexts, uncond = _sdxl_base(parts)
    vae_cfg = vae_config(SDXL_VAE_CONFIG)
    vae = VAE(vae_cfg, device=dev, generator=gen)
    vae.reset_parameters(gen, noise=0.02)
    vae.requires_grad_(False)
    stack = SDXLStack(unet, vae)
    (ctx, pooled), tid = contexts[0], SDXLStack.time_ids((1024, 1024), (0, 0), (1024, 1024), device=dev)
    igen = torch.Generator(dev).manual_seed(171)
    image = (torch.rand((1, 3, 1024, 1024), generator=igen, device=dev) > 0.9).float()  # a canny-like edge map

    def pipe(steps: int = SDXL_STEPS, **control):
        return stack.pipeline(
            ctx, pooled, height=1024, width=1024, steps=steps, guidance_scale=5.0, uncond=uncond, device=dev,
            **control,
        )

    plain_pipe = pipe()
    cn_pipe = pipe(controlnet=cn, control_image=image, control_scale=1.0)
    zero_pipe = pipe(controlnet=cn, control_image=image, control_scale=0.0)
    # per CFG forward: the ControlNet's B8 21 (2 a resnet: 6 down, 2 mid; 5 Transformer2D), B10 34 (2 x 2 + 2 x 10
    # down, 10 mid), B12 22 (conv_in, 2 a resnet, the ladder's 5 stride-1 convs), beside the UNet's 46, 70 and 38
    cn_per_forward = {"groupnorm_forward": 21, "flash_attention_pairs_forward": 34, "conv3x3_gn_silu_forward": 22}
    unet_per_forward = {"groupnorm_forward": 46, "flash_attention_pairs_forward": 70, "conv3x3_gn_silu_forward": 38}
    per_step = dict.fromkeys(_wrappers(), 0)
    per_step.update({k: cn_per_forward[k] + unet_per_forward[k] for k in cn_per_forward}, fused_step_cuda=1)
    per_decode = fused_convs_per_decode(vae_cfg)
    want = {k: v * SDXL_STEPS for k, v in per_step.items()}
    want["conv3x3_gn_silu_forward"] += per_decode
    want["groupnorm_forward"] += 1
    sgen = torch.Generator(dev).manual_seed(172)
    x = torch.randn((1, 4, 128, 128), generator=sgen, device=dev)
    with torch.inference_mode():
        # warm-up: one guided ControlNet step (its dense shapes recorded for 17d), then the plain request and the
        # request at scale 0
        fn = stack.model_fn(ctx, pooled, tid, 5.0, uncond, controlnet=cn, control_image=image)
        recorder(lambda: fn(x, torch.tensor(500.0, device=dev), None, None))
        t0 = time.perf_counter()
        plain = plain_pipe.generate(1)
        zeroed = zero_pipe.generate(1)
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        same = torch.equal(zeroed, plain)
        print(
            f"controlnet 17a: SDXLStack.pipeline(controlnet=cn, control_scale=0.0).generate(1) vs the same request "
            f"without a ControlNet (1024x1024, CFG 5.0, {SDXL_STEPS} steps): bit-equal {same}, relative max err "
            f"{_relative(zeroed, plain):.3e} (the two requests in {pair_s * 1e3:.1f} ms)"
        )
        expect(same, f"controlnet 17a: scale 0 moves the latent by {_relative(zeroed, plain)}")

        # ---- the main path: a ControlNet-guided request to pixels, the counters from 0 ----
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        t0 = time.perf_counter()
        latent = cn_pipe.generate(1)
        pixels = stack.decode(latent)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        print(f"controlnet 17a: launches {launches} (expected {want}: per step {per_step}, a decode B12 {per_decode} "
              f"f32 and B8 1)")
        print(f"controlnet 17a: attention launches by route: {_attention_routes()}")
        expect(launches == want, f"controlnet 17a: launched {launches}, expected {want}")
        # conv_in of the UNet and of the ControlNet (C = 4) and the ladder's conv_in (C = 3) take the mma.sync kernel
        routes = _routes()["conv3x3_gn_silu_forward"]
        want_routes = {"wgmma": 57 * SDXL_STEPS, "mma_sync": 3 * SDXL_STEPS, "f32": per_decode}
        print(f"controlnet 17a: B12 launches by route {routes} (expected {want_routes})")
        expect(routes == want_routes, f"controlnet 17a: B12 routes {routes}, expected {want_routes}")
        for name, count in launches.items():
            total[name] += count
        steered = _relative(latent, plain)
        print(
            f"controlnet 17a: pixels {tuple(pixels.shape)} finite {bool(torch.isfinite(pixels).all())}, range "
            f"[{pixels.min().item():.3f}, {pixels.max().item():.3f}]; the control image moves the latent by "
            f"{steered:.3e} relative; request to pixels {first_s * 1e3:.1f} ms (the first); peak {peak / 2**30:.2f} GiB "
            f"({card})"
        )
        ok = tuple(pixels.shape) == (1, 3, 1024, 1024) and bool(torch.isfinite(pixels).all())
        expect(ok, "controlnet 17a: bad pixels")
        expect(steered > 1e-3, f"controlnet 17a: the control image does not move the latent ({steered})")
        times = []
        for seed in (2, 3, 4):
            t0 = time.perf_counter()
            cn_pipe.generate(seed).cpu()
            times.append(time.perf_counter() - t0)
        median = statistics.median(times)
        print(
            f"controlnet 17a: request latency (a latent, {SDXL_STEPS} CFG steps of the ControlNet and the UNet), "
            f"median {median * 1e3:.1f} ms of 3 ({', '.join(f'{v * 1e3:.1f}' for v in times)}); phase 7's request "
            f"without one: PERF.md ({card})"
        )
        # the trace: a request of the same path cut to TRACE_STEPS steps (a whole one took 94 s under the profiler:
        # 168125 launches); its busy share is read against the same cut request's untraced median
        short = pipe(TRACE_STEPS, controlnet=cn, control_image=image, control_scale=1.0)
        short_times = []
        for seed in (5, 6, 7):
            t0 = time.perf_counter()
            short.generate(seed).cpu()
            short_times.append(time.perf_counter() - t0)
        _traced_dispatch(
            lambda: short.generate(8).cpu(), f"controlnet 17a {TRACE_STEPS}-step request", statistics.median(short_times),
            card, SDXL_GROUPS,
        )

        # ---- one CFG step through the kernels, then through the plain versions ----
        args = (
            torch.cat([x, x]), torch.tensor([500.0, 500.0], device=dev), torch.stack([ctx, uncond[0]]),
            torch.stack([pooled, uncond[1]]), tid.expand(2, 6),
        )
        image2 = image.expand(2, -1, -1, -1)
        _reset_counters()
        got = unet(*args, control=cn(*args[:3], image2, *args[3:]))
        step_counts = _counters()
        with (
            mock.patch.object(groupnorm, "groupnorm_forward", groupnorm.groupnorm_reference),
            mock.patch.object(flash_attention, "flash_attention_pairs_forward", flash_attention._packed_reference),
            mock.patch.object(fused_conv, "conv3x3_gn_silu_forward", _plain_b12),
        ):
            want_out = unet(*args, control=cn(*args[:3], image2, *args[3:]))
        torch.cuda.synchronize()
    step_want = dict(per_step, fused_step_cuda=0)
    expect(step_counts == step_want, f"controlnet 17a: one CFG step launched {step_counts}, expected {step_want}")
    expect(_counters() == step_counts, f"controlnet 17a: the plain step launched kernels: {_counters()}")
    vs_plain = _relative(got, want_out)
    print(
        f"controlnet 17a: one CFG step (the ControlNet, then the UNet with its residuals) through the kernels vs the "
        f"plain versions: relative max err {vs_plain:.3e} (tolerance 5e-2)"
    )
    expect(bool(torch.isfinite(want_out).all()) and vs_plain <= 5e-2, f"controlnet 17a: kernels vs plain {vs_plain}")
    return unet, args, got


def _int8_scopes_part(card: str, unet, args: tuple, total: dict[str, int]) -> None:
    """17b: the UNet's int8 scopes, one CFG forward each against bf16's (no ControlNet); then each forward's time
    in turns (bf16, deep, all, three rounds), CUDA events around an eager forward."""
    import gc

    import torch

    from skrample_tpu_torch.ops import quant

    models = {"bf16": unet}
    with torch.inference_mode():
        bf16_out = unet(*args)
        for scope, n_want in (("deep", 432), ("all", 512)):
            t0 = time.perf_counter()
            int8 = unet.quantize_params(scope)
            torch.cuda.synchronize()
            quantize_s = time.perf_counter() - t0
            n_int8 = sum(isinstance(m, quant.Int8Dense) for m in int8.modules())
            _reset_counters()
            out = int8(*args)
            torch.cuda.synchronize()
            counts = _counters()
            want = dict.fromkeys(_wrappers(), 0)
            want.update(groupnorm_forward=46, flash_attention_pairs_forward=70, conv3x3_gn_silu_forward=38,
                        quantize_rows=n_int8)
            cosine = _cosine(out, bf16_out)
            print(
                f"int8 17b: quantize_params({scope!r}) in {quantize_s:.1f} s: {n_int8} int8 layers (expected "
                f"{n_want}); one CFG forward at 1024x1024 launched B6 {counts['quantize_rows']}, cosine to bf16 "
                f"{cosine:.6f} (> 0.99)"
            )
            expect(n_int8 == n_want and counts == want, f"int8 17b {scope}: {n_int8} int8 layers, launches {counts}")
            expect(bool(torch.isfinite(out).all()) and cosine > 0.99, f"int8 17b {scope}: cosine {cosine}")
            for name, count in counts.items():
                total[name] += count
            models[scope] = int8
        times: dict[str, list[float]] = {name: [] for name in models}
        for _ in range(3):
            for name, model in models.items():
                times[name].append(_events_ms(lambda m=model: m(*args), 1))
    print(
        "int8 17b: one CFG forward of SDXL base at 1024x1024 (CUDA events around an eager forward, in turns; median "
        "of 3): " + ", ".join(f"{k} {statistics.median(v):.2f} ms ({', '.join(f'{x:.2f}' for x in v)})"
                              for k, v in times.items()) + f" ({card})"
    )
    del models
    gc.collect()
    torch.cuda.empty_cache()


def _flux_stack_part(card: str, recorder, total: dict[str, int]) -> None:
    "17c: FluxStack from text ids to pixels at FLUX.1-dev's widths."
    import gc

    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.flux import Flux, FluxConfig
    from skrample_tpu_torch.models.flux_stack import FluxStack, dynamic_shift
    from skrample_tpu_torch.models.import_weights import vae_config
    from skrample_tpu_torch.models.t5_encoder import T5Encoder, T5EncoderConfig
    from skrample_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
    from skrample_tpu_torch.models.vae import VAE, fused_convs_per_decode
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(175)
    t0 = time.perf_counter()
    config = FluxConfig(  # phase 6's: FLUX.1-dev transformer/config.json
        dim=3072, heads=24, depth=19, single_depth=38, context_dim=4096, pooled_dim=768, guidance=True,
        compute_dtype=bf16, attention="flash",
    )
    flux = Flux(config, device=dev, generator=gen, dtype=bf16)
    flux.reset_parameters(gen, noise=0.02)
    clip = TextEncoder(TextEncoderConfig(**CLIP_L_CONFIG, compute_dtype=bf16), device=dev, generator=gen, dtype=bf16)
    with torch.no_grad():  # a CLIP without a projection: its pooled output is the EOS feature itself
        clip.text_proj.weight.copy_(torch.eye(768, device=dev))
        clip.text_proj.bias.zero_()
    t5 = T5Encoder(T5EncoderConfig(**T5_XXL_CONFIG, compute_dtype=bf16), device=dev, generator=gen, dtype=bf16)
    vae_cfg = vae_config(FLUX_VAE_CONFIG)
    vae = VAE(vae_cfg, device=dev, generator=gen)
    vae.reset_parameters(gen, noise=0.02)
    for module in (flux, clip, t5, vae):
        module.requires_grad_(False)
    stack = FluxStack(flux, vae, clip, t5)
    torch.cuda.synchronize()
    counts = {name: sum(p.numel() for p in m.parameters()) for name, m in
              (("Flux", flux), ("CLIP-L", clip), ("T5-XXL", t5), ("VAE", vae))}
    print(
        f"flux stack 17c: FLUX.1-dev widths drawn on the card in {time.perf_counter() - t0:.1f} s: "
        f"{', '.join(f'{k} {v / 1e9:.3f}B' for k, v in counts.items())} parameters (bf16; the VAE f32, shift "
        f"{vae_cfg.shift_factor}, scale {vae_cfg.scaling_factor}); {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated"
    )
    clip_tok, t5_tok = _synthetic_tokenizers()

    def encode(prompts) -> tuple:
        "Text to (context, pooled): CLIP-L's 77 ids padded with its EOS, T5's 512."
        return stack.encode_prompt(clip_tok(prompts), t5_tok(prompts, length=FLUX_T5_TOKENS))

    item_shape = (16, 128, 128)  # 1024x1024 through the VAE's factor 8: 4096 image tokens at patch 2
    shift = dynamic_shift(4096)
    per_forward = dict.fromkeys(_wrappers(), 0)
    per_forward.update(  # phase 6's: K2 a block, K3 4 a double block + 1 a single + the final one, B7 2 + 1
        flash_attention_qkv_forward=config.depth + config.single_depth,
        adaln_forward=4 * config.depth + config.single_depth + 1,
        rope_qk_norm_forward=2 * config.depth + config.single_depth,
    )
    per_decode = fused_convs_per_decode(vae_cfg)
    served = stack.as_served(3.5)
    zgen = torch.Generator(dev).manual_seed(176)
    with torch.inference_mode():  # warm-up: the towers, both buckets' forwards (recorded for 17d), the decodes
        warm = recorder(lambda: encode(list(SD3_PROMPTS)))
        recorder(lambda: encode(list(SD3_PROMPTS[:1])))
        for b in (1, 2):
            x = torch.randn((b, *item_shape), generator=zgen, device=dev)
            recorder(lambda b=b, x=x: served(x, torch.tensor(500.0, device=dev), None, None, (warm[0][:b], warm[1][:b])))
            stack.decode(x)
        torch.cuda.synchronize()
    engine = ServingEngine(
        served, item_shape=item_shape, sampler=structured.Euler(),
        schedule=scheduling.FlowShift(scheduling.Linear(), shift=shift), model_transform=models.FlowModel(),
        steps=FLUX_STACK_STEPS, dtype=torch.float32, buckets=(1, 2), conditioned=True, device=dev,
        postprocess=stack.decode,
    )
    with engine:
        # the main path: text ids to pixels, requests A and B together, then A again alone
        torch.cuda.reset_peak_memory_stats()
        batches_before = engine.stats.batches
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        with torch.inference_mode():
            ctx, pooled = encode(list(SD3_PROMPTS))
            torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        requests = [(1, (ctx[0], pooled[0])), (2, (ctx[1], pooled[1]))]
        outs = [f.result().cpu() for f in [engine.submit(seed, context=c) for seed, c in requests]]
        t0 = time.perf_counter()
        outs.append(engine.generate(requests[0][0], context=requests[0][1]).cpu())
        solo_s = [time.perf_counter() - t0]
        torch.cuda.synchronize()
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        dispatches = engine.stats.batches - batches_before
        forwards = FLUX_STACK_STEPS * dispatches
        want = {name: n * forwards for name, n in per_forward.items()}
        want.update(fused_step_cuda=forwards, conv3x3_gn_silu_forward=per_decode * dispatches, groupnorm_forward=dispatches)
        print(
            f"flux stack 17c: 2 prompts encoded (CLIP-L 77 ids, T5-XXL {FLUX_T5_TOKENS}) in {encode_s * 1e3:.1f} ms; "
            f"3 requests in {dispatches} dispatches ({engine.stats.bucket_counts}); Euler over FlowShift(Linear, "
            f"{shift:.4f}), {FLUX_STACK_STEPS} steps; launches {launches} (expected {want})"
        )
        print(f"flux stack 17c: attention launches by route: {_attention_routes()}")
        expect(dispatches == 2 and launches == want, f"flux stack 17c: launches {launches}, expected {want}")
        expect(_routes()["conv3x3_gn_silu_forward"]["f32"] == want["conv3x3_gn_silu_forward"],
               f"flux stack 17c: B12 routes {_routes()['conv3x3_gn_silu_forward']}")
        for o in outs:
            ok = tuple(o.shape) == (3, 1024, 1024) and bool(torch.isfinite(o).all())
            expect(ok, f"flux stack 17c: bad pixels {o.shape}")
        same = torch.equal(outs[2], outs[0])
        print(
            f"flux stack 17c: pixels (3, 1024, 1024) finite, range [{outs[0].min().item():.3f}, "
            f"{outs[0].max().item():.3f}]; request A alone == A packed, bit for bit: {same}"
        )
        expect(same, f"flux stack 17c: packing changes request A's pixels by {_relative(outs[2], outs[0])}")
        for name, count in launches.items():
            total[name] += count

        with torch.inference_mode():
            pipe = stack.pipeline(ctx[0], pooled[0], 1024, 1024, steps=FLUX_STACK_STEPS, guidance=3.5, device=dev)
            expect(pipe.schedule.shift == shift, f"flux stack 17c: the pipeline's shift {pipe.schedule.shift}")
            piped = stack.decode(pipe.generate(requests[0][0])).cpu()[0]
        equal = torch.equal(piped, outs[2])
        print(
            f"flux stack 17c: stack.pipeline(...).generate(1) decoded vs the served request A alone (seed 1): bit-equal "
            f"{equal}, relative max err {_relative(piped, outs[2]):.3e}"
        )
        expect(equal, f"flux stack 17c: the pipeline differs from the served request by {_relative(piped, outs[2])}")

        for seed in (500, 501):
            t0 = time.perf_counter()
            engine.generate(seed, context=requests[0][1]).cpu()
            solo_s.append(time.perf_counter() - t0)
        solo = statistics.median(solo_s)
        print(
            f"flux stack 17c: request latency to pixels ({FLUX_STACK_STEPS} steps and the decode; the prompt encoded "
            f"before), bucket 1: median {solo * 1e3:.1f} ms of {len(solo_s)} ({', '.join(f'{v * 1e3:.1f}' for v in solo_s)}); "
            f"peak {peak / 2**30:.2f} GiB ({card})"
        )
        _traced_dispatch(
            lambda: engine.generate(700, context=requests[0][1]).cpu(), "flux stack 17c bucket 1", solo, card,
            FLUX_GROUPS[:-1] + (("B12 convs", B12_KERNELS), ("B8 groupnorm", B8_KERNELS)) + FLUX_GROUPS[-1:],
            share="K2 flash_qkv",
        )
    del engine, served, stack, flux, clip, t5, vae
    gc.collect()
    torch.cuda.empty_cache()


def controlnet_flux_phase(card: str, parts: dict) -> dict[str, int]:
    """Phase 17: A8's rest.  (a) ControlNet over SDXL base: the ControlNet imported at controlnet-canny-sdxl-1.0's
    widths by ``diffusers_controlnet`` from a synthetic state dict, loaded into bf16 on the card and drawn random;
    ``SDXLStack(unet, vae).pipeline(controlnet=, control_image=)`` at 1024x1024, CFG 5.0, 25 steps, a 1024x1024
    control image: scale 0 bit for bit the request without one; the scale-1 request to pixels with exact
    launches by kernel and route (B8 67, B10 104, B12 60 a step, K1 a step), the median of 3, a traced one;
    one CFG step against the plain versions (5e-2).  (b) The UNet's int8 scopes: ``quantize_params()`` ("deep",
    B6 432 a CFG forward) and ``("all")`` (B6 512), cosine > 0.99 to bf16, the card time of each forward beside
    bf16's.  (c) ``FluxStack`` at FLUX.1-dev's widths (the transformer, CLIP-L, the T5-XXL encoder at 512
    tokens, the Flux VAE f32), random weights drawn on the card, from text ids to 1024x1024 pixels through
    ``ServingEngine(stack.as_served(3.5), conditioned=True, postprocess=stack.decode)``, Euler over
    FlowShift(Linear, dynamic_shift(4096)), 10 steps (FLUX.1-dev's 28 cut): 3 requests (2 together, then the
    first alone, bit for bit its packed twin), ``stack.pipeline`` bit for bit the request alone, exact
    launches, the median latency, a traced request.  (d) ROADMAP C6 at the dense shapes of (a)-(c): the
    epilogue route against the two passes, bit for bit.  Returns the main paths' launches."""
    import gc

    import torch

    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    recorder = _DenseShapes()
    unet, args, _ = _controlnet_part(card, parts, recorder, total)
    print(f"controlnet 17a: took {time.perf_counter() - phase_t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _int8_scopes_part(card, unet, args, total)
    print(f"int8 17b: took {time.perf_counter() - t0:.1f} s")
    del unet, args
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _flux_stack_part(card, recorder, total)
    print(f"flux stack 17c: took {time.perf_counter() - t0:.1f} s")
    _epilogue_check(recorder.shapes, None, "controlnet 17d", "phase 17's models (ControlNet, T5-XXL, CLIP-L, Flux)")
    print(f"controlnet: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


# phase 18: the text-to-image trainer at SD3.5-medium's widths (native wiring, the example's) and CLIP-L's
T2I_MEDIUM = {
    "patch": 2, "channels": 16, "dim": 1536, "depth": 24, "heads": 24, "context_dim": 768, "context_tokens": 128,
    "qk_norm": True, "dual_attention_layers": tuple(range(13)),
}
T2I_CLIP_L = {"dim": 768, "depth": 12, "heads": 12, "mlp_ratio": 4, "max_tokens": 128, "causal": True}
T2I_BATCH, T2I_SIZE, T2I_STEPS, T2I_TIMED_FROM = 4, 64, 20, 5  # steps 5-20 give the median
T2I_GROUPS = (
    ("K6 adaln_bwd", ("adaln_bwd_kernel", "adaln_bwd_reduce_kernel")),
    ("K3 adaln", ("adaln_kernel",)),
    ("B7 rope_qk_norm", ("rope_qk_norm_kernel",)),
    ("B10 flash_pairs", ("flash_strided_sm90_kernel",)),
    ("B11 block_stats", ("flash_block_stats_sm90_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "splitk", "nvjet")),
    ("AdamW", ("multi_tensor_apply",)),
    ("NCCL", ("nccl",)),
)
MESH_REQUESTS = (SEEDS[0], SEEDS[1], SEEDS[2])  # 18b: two together, then one alone


def _t2i_per_step(config) -> dict[str, int]:
    """Launches of one joint step: the MMDiT forward's (K3, B7, B10; the encoder runs none), K6 once for every K3
    the loss reaches (all but the last block's text-stream MLP modulation, whose output nothing reads); B7's and
    B10's backwards are their plain versions' gradients."""
    per = _mmdit_per_forward(config)
    per["adaln_backward"] = per["adaln_forward"] - 1
    return per


def _t2i_plain_kernels():
    "The joint step's kernels swapped for their plain versions (K3, K6, B7, B10)."
    from skrample_tpu_torch.ops import adaln

    return (*_plain_kernels(), mock.patch.object(adaln, "adaln_backward", adaln.adaln_backward_reference))


def _t2i_trainer_part(card: str, total: dict[str, int]) -> None:
    """18a: the trainer at SD3.5-medium's widths in the native wiring with the CLIP-L-width encoder."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from skrample_tpu_torch import prng
    from skrample_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from skrample_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
    from skrample_tpu_torch.train_text_to_image import (
        STEP_SEED,
        hermetic_data,
        t2i_draws,
        t2i_loss,
        t2i_optimizer,
        t2i_train_step,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(180)
    enc = TextEncoder(TextEncoderConfig(**T2I_CLIP_L, compute_dtype=bf16), device=dev, generator=gen)
    m_config = MMDiTConfig(**T2I_MEDIUM, compute_dtype=bf16, attention="flash")
    mmdit = MMDiT(m_config, device=dev, generator=gen)
    mmdit.reset_parameters(gen, noise=0.02)  # Flux's recipe: adaLN-zero would leave most gradients 0
    n_params = sum(p.numel() for m in (enc, mmdit) for p in m.parameters())
    ids, images = hermetic_data(T2I_SIZE, channels=16, device=dev)
    keys = prng.split(prng.PRNGKey(STEP_SEED), T2I_STEPS)
    draws = [t2i_draws(key, T2I_BATCH, T2I_SIZE, 0.1, channels=16, device=dev) for key in keys]
    per_step = _t2i_per_step(m_config)
    print(
        f"t2i 18a: MMDiT at SD3.5-medium's widths (native wiring, qk-norm, dual attention in blocks 0-12) + "
        f"TextEncoder at CLIP-L's widths: {n_params / 1e9:.3f}B parameters (f32 masters, bf16 compute, no remat); batch "
        f"{T2I_BATCH} of 16x{T2I_SIZE}x{T2I_SIZE} latents, 128 byte ids, CFG dropout 0.1, AdamW 1e-4"
    )

    # ---- one step's loss and gradients through the kernels against the plain versions (before any update) ----
    grads, step_losses = [], []
    params = [p for m in (enc, mmdit) for p in m.parameters()]
    for plain in (False, True):
        for p in params:
            p.grad = None
        _reset_counters()
        with contextlib.ExitStack() as patches:
            for patch in _t2i_plain_kernels() if plain else ():
                patches.enter_context(patch)
            loss = t2i_loss(enc, mmdit, ids, images, *draws[0])
            loss.backward()
        torch.cuda.synchronize()
        counts = _counters()
        want = dict.fromkeys(per_step, 0) if plain else per_step
        expect(counts == want, f"t2i 18a: the {'plain' if plain else 'kernel'} step launched {counts}, expected {want}")
        step_losses.append(loss.item())
        grads.append([None if p.grad is None else p.grad.clone() for p in params])
    for p in params:
        p.grad = None
    names = [f"enc.{n}" for n, _ in enc.named_parameters()] + [f"mmdit.{n}" for n, _ in mmdit.named_parameters()]
    pairs = [(i, a, b) for i, (a, b) in enumerate(zip(*grads)) if a is not None and b is not None and b.norm() > 0]
    rel = {i: _relative_fro(a, b) for i, a, b in pairs}
    worst = max(rel, key=rel.get)
    loss_rel = abs(step_losses[0] - step_losses[1]) / abs(step_losses[1])
    print(
        f"t2i 18a: kernels vs plain versions, one step: loss {step_losses[0]:.6f} vs {step_losses[1]:.6f}, relative "
        f"{loss_rel:.3e} (tolerance 1e-2); grads relative Frobenius max {rel[worst]:.3e} ({names[worst]}), median "
        f"{statistics.median(rel.values()):.3e} over {len(rel)} nonzero tensors (tolerance 5e-2, bf16)"
    )
    expect(loss_rel <= 1e-2, f"t2i 18a: kernel loss differs from plain by {loss_rel}")
    expect(all(bool(torch.isfinite(a).all()) for _, a, _ in pairs), "t2i 18a: non-finite kernel-path gradient")
    expect(rel[worst] <= 5e-2, f"t2i 18a: kernel gradient {names[worst]} differs from plain by {rel[worst]}")
    del grads, pairs
    gc.collect()

    # ---- the main path: 20 joint steps, counters from 0 ----
    opt = t2i_optimizer(enc, mmdit)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    times, losses = [], []
    for step in range(T2I_STEPS):
        t0 = time.perf_counter()
        losses.append(t2i_train_step(enc, mmdit, opt, ids, images, draws[step]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    want = {name: n * T2I_STEPS for name, n in per_step.items()}
    print(f"t2i 18a: launches over {T2I_STEPS} steps {launches} (a step: {per_step})")
    expect(launches == want, f"t2i 18a: launched {launches}, expected {want}")
    for name, count in launches.items():
        total[name] += count
    values = torch.stack(losses).tolist()
    first, last = statistics.fmean(values[:5]), statistics.fmean(values[-5:])
    timed = times[T2I_TIMED_FROM - 1 :]
    print(
        f"t2i 18a: step time median {statistics.median(timed):.2f} ms of steps {T2I_TIMED_FROM}-{T2I_STEPS} (min "
        f"{min(timed):.2f}, max {max(timed):.2f}; first step {times[0]:.2f}); peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); {card}"
    )
    print(f"t2i 18a: loss, mean of the first 5 steps {first:.4f} -> mean of the last 5 {last:.4f} ({values})")
    expect(all(map(math.isfinite, values)), f"t2i 18a: non-finite loss {values}")
    expect(last < first, f"t2i 18a: the loss did not fall: {first} -> {last}")

    # ---- where a step's card time goes: one traced step ----
    median_s = statistics.median(timed) / 1e3
    extra = t2i_draws(prng.fold_in(prng.PRNGKey(STEP_SEED), 99), T2I_BATCH, T2I_SIZE, 0.1, channels=16, device=dev)
    traced = _traced_dispatch(
        lambda: t2i_train_step(enc, mmdit, opt, ids, images, extra), "t2i 18a step", median_s, card, T2I_GROUPS
    )
    print(f"t2i 18a: {sum(traced.values())} kernel launches a traced step ({card})")
    del enc, mmdit, opt, losses, draws, extra
    gc.collect()
    torch.cuda.empty_cache()


MESH_ROUNDS = 3  # 18b: rounds of 3 requests, the mesh-less engine and the mesh one in turns


def _mesh_engines_part(card: str, mesh, total: dict[str, int]) -> None:
    """18b: the engines and the pipeline over ``make_mesh(dp=1, sp=1)`` against their mesh-less twins, bit for
    bit, over phase 3's DiT-512/8; each pair timed in turns (``MESH_ROUNDS`` rounds), the counters read over the
    mesh engine's first round."""
    import torch

    from skrample_tpu_torch.continuous import ContinuousServingEngine
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.pipeline import build_pipeline
    from skrample_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda", 0)
    config = DiTConfig(dim=512, depth=DEPTH, heads=4, channels=4, compute_dtype=torch.bfloat16, attention="flash")
    model = DiT(config, device=dev).load_jax_params(random_param_tree(config, seed=0)).requires_grad_(False)
    item = (4, 64, 64)
    per_request = dict.fromkeys(_wrappers(), 0)
    per_request.update(
        fused_step_cuda=STEPS, flash_attention_qkv_forward=DEPTH * STEPS, adaln_forward=(2 * DEPTH + 1) * STEPS
    )

    def batched(engine) -> list:  # two requests together, then one alone: two dispatches
        pair = [engine.submit(s) for s in MESH_REQUESTS[:2]]
        return [f.result() for f in pair] + [engine.generate(MESH_REQUESTS[2])]

    def pooled(engine) -> list:  # three requests into the 4-slot pool at once
        return [f.result() for f in [engine.submit(s) for s in MESH_REQUESTS]]

    def in_turns(label: str, engines: dict, run, want: dict | None, requests: int = len(MESH_REQUESTS)) -> None:
        "Warm both, then rounds in turns: bit-equal outputs, exact launches, and each side's median (ms)."
        for engine in engines.values():
            run(engine)  # warm-up: both buckets (the graphs' captures), the groups' first collectives
        times: dict[bool, list[float]] = {False: [], True: []}
        outs, counts = {}, {}
        for _round in range(MESH_ROUNDS):
            for meshed, engine in engines.items():
                torch.cuda.synchronize()
                _reset_counters()
                t0 = time.perf_counter()
                got = run(engine)
                torch.cuda.synchronize()
                times[meshed].append((time.perf_counter() - t0) * 1e3)
                launches = _counters()
                if meshed not in outs:
                    outs[meshed], counts[meshed] = got, launches
        same, err = _same(outs[True], outs[False])
        spread = {k: f"{statistics.median(v):.1f} ms ({min(v):.1f}-{max(v):.1f})" for k, v in times.items()}
        print(
            f"t2i 18b: {label}: {requests} request(s), median of {MESH_ROUNDS} rounds in turns {spread[True]} "
            f"with the mesh, "
            f"{spread[False]} without ({card}); bit-equal {same} (max abs diff {err:.3e}); launches {counts[True]}"
        )
        expect(same, f"t2i 18b: {label} differs from its mesh-less twin by {err}")
        if want is not None:
            for meshed in (False, True):
                got = counts[meshed]
                expect(got == want, f"t2i 18b: {label} (mesh {meshed}) launched {got}, expected {want}")
        else:  # the pool's tick count follows the admissions' timing: every kernel of the tick ran
            ran = all(counts[True][n] > 0 for n in ("fused_step_cuda", "flash_attention_qkv_forward", "adaln_forward"))
            expect(ran, f"t2i 18b: {label} launched {counts[True]}")
        for name, count in counts[True].items():
            total[name] += count

    for graph in (False, True):
        with contextlib.ExitStack() as stack:
            engines = {
                meshed: stack.enter_context(
                    ServingEngine(
                        model.as_sampleable(), item_shape=item, steps=STEPS, buckets=(1, 2), max_delay_ms=50.0,
                        mesh=mesh if meshed else None, device=dev, graph=graph,
                    )
                )
                for meshed in (False, True)
            }
            label = f"ServingEngine(mesh=dp 1, {'graphed' if graph else 'eager'}) over DiT-512/8"
            in_turns(label, engines, batched, {name: n * 2 for name, n in per_request.items()})
    with contextlib.ExitStack() as stack:
        engines = {
            meshed: stack.enter_context(
                ContinuousServingEngine(
                    model.as_sampleable(), item_shape=item, steps=STEPS, slots=4, mesh=mesh if meshed else None,
                    device=dev,
                )
            )
            for meshed in (False, True)
        }
        in_turns("ContinuousServingEngine(mesh=dp 1, 4 slots)", engines, pooled, None)

    pipes = {
        meshed: build_pipeline(model.as_sampleable(), (1, *item), steps=STEPS, mesh_axes={"x": 1} if meshed else None,
                               device=dev)
        for meshed in (False, True)
    }
    in_turns(
        "GenerationPipeline(mesh=build_pipeline(mesh_axes={'x': 1}))", pipes, lambda p: [p.generate(MESH_REQUESTS[0])],
        per_request, requests=1,
    )


def _mesh_models_part(card: str, mesh, total: dict[str, int]) -> None:
    """18b: the sequence-parallel VideoDiT and MMDiT and one ``--dp 1`` step of each trainer on the one-rank mesh."""
    import dataclasses
    import gc

    import torch

    from skrample_tpu_torch import prng, training
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.models.ema import ema_init
    from skrample_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from skrample_tpu_torch.models.video_dit import VideoDiT, VideoDiTConfig
    from skrample_tpu_torch.train_text_to_image import (
        build_models,
        hermetic_data,
        t2i_draws,
        t2i_optimizer,
        t2i_train_step,
    )

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16

    # ---- the VideoDiT at phase 10's widths, sequence_parallel over the one rank ----
    gen = torch.Generator(dev).manual_seed(10)
    v_cfg = VideoDiTConfig(dim=512, depth=8, heads=4, channels=16, compute_dtype=bf16, attention="flash")
    video = VideoDiT(v_cfg, device=dev, generator=gen)
    video.reset_parameters(gen, noise=0.02)
    video_sp = VideoDiT(dataclasses.replace(v_cfg, sequence_parallel=True), mesh=mesh, device=dev)
    video_sp.load_state_dict(video.state_dict())
    x = torch.randn((1, 16, 16, 64, 64), generator=gen, device=dev)
    with torch.inference_mode():
        want = video(x, 500.0)
        _reset_counters()
        got = video_sp(x, 500.0)
        counts = _counters()
    same, err = _same([got], [want])
    print(f"t2i 18b: VideoDiT(sequence_parallel=True) at phase 10's widths, 16 frames of 64x64: bit-equal {same} "
          f"(max abs diff {err:.3e}) to the mesh-less forward; launches {counts}")
    expect(same, f"t2i 18b: the sequence-parallel VideoDiT differs by {err}")
    for name, count in counts.items():
        total[name] += count
    del video, video_sp, x, want, got

    # ---- one --dp 1 step of each trainer against the same step without a mesh ----
    config = DiTConfig(dim=512, depth=DEPTH, heads=4, channels=4, compute_dtype=bf16, attention="flash")
    tree = random_param_tree(config, seed=0)
    data = training.synthetic_dataset(64, dev)
    batch = training.draw_batch(data, 4, torch.Generator(device=dev).manual_seed(1))
    trained = []
    for m in (None, mesh):
        model = DiT(config, device=dev).load_jax_params(tree)
        opt = training.make_optimizer(model)
        _reset_counters()
        loss = training.train_step(model, opt, ema_init(model), *batch, 0, mesh=m)
        torch.cuda.synchronize()
        counts = _counters()
        if m is not None:
            for name, count in counts.items():
                total[name] += count
        trained.append((loss, [p.detach().clone() for p in model.parameters()]))
    same, err = _same([trained[1][0], *trained[1][1]], [trained[0][0], *trained[0][1]])
    print(f"t2i 18b: training.train_step(mesh=dp 1) on DiT-512/8: loss and parameters bit-equal {same} (max abs diff "
          f"{err:.3e}) to the mesh-less step; launches {counts}")
    expect(same, f"t2i 18b: the dp step of the DiT trainer differs by {err}")
    t0 = time.perf_counter()
    rc = training.main(["--dp", "1", "--steps", "3", "--dim", "512", "--depth", "2", "--heads", "4", "--size", "32"])
    print(f"t2i 18b: python -m skrample_tpu_torch.training --dp 1 inside the one-rank group: exit {rc} in "
          f"{time.perf_counter() - t0:.1f} s")
    expect(rc == 0, f"t2i 18b: training.main --dp 1 exited {rc}")

    ids, images = hermetic_data(16, device=dev)
    draws = t2i_draws(prng.PRNGKey(2), 8, 16, 0.1, device=dev)
    stepped = []
    for m in (None, mesh):
        enc, mm = build_models(128, dev)
        _reset_counters()
        loss = t2i_train_step(enc, mm, t2i_optimizer(enc, mm), ids, images, draws, m)
        torch.cuda.synchronize()
        counts = _counters()
        if m is not None:
            for name, count in counts.items():
                total[name] += count
        stepped.append([loss, *(p.detach().clone() for mod in (enc, mm) for p in mod.parameters())])
    same, err = _same(stepped[1], stepped[0])
    print(f"t2i 18b: t2i_train_step(mesh=dp 1) at the example's widths (dim 128): loss and parameters bit-equal "
          f"{same} (max abs diff {err:.3e}) to the mesh-less step; launches {counts}")
    expect(same, f"t2i 18b: the dp step of the text-to-image trainer differs by {err}")
    del trained, stepped
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the SD3.5-medium-width MMDiT with ring and ulysses against flash: one forward each ----
    gen = torch.Generator(dev).manual_seed(181)
    flash_config = MMDiTConfig(**T2I_MEDIUM, compute_dtype=bf16, attention="flash")
    flash = MMDiT(flash_config, device=dev, generator=gen, dtype=bf16)
    flash.reset_parameters(gen, noise=0.02)
    flash.requires_grad_(False)
    x = torch.randn((2, 16, T2I_SIZE, T2I_SIZE), generator=gen, device=dev)
    t = torch.tensor([500.0, 20.0], device=dev)
    ctx = torch.randn((2, 128, T2I_MEDIUM["context_dim"]), generator=gen, device=dev)
    per_forward = _mmdit_per_forward(flash.config)
    joint = per_forward.pop("flash_attention_pairs_forward")
    with torch.inference_mode():
        want = flash(x, t, ctx)
        flash_ms = _median_step_ms(lambda _i: flash(x, t, ctx), 5)
        print(f"t2i 18b: SD3.5-medium-width MMDiT, flash: forward at batch 2 of 16x64x64 median {flash_ms[0]:.2f} ms "
              f"(min {flash_ms[1]:.2f}, max {flash_ms[2]:.2f}; {card})")
        for attention, kernel in (("ring", "flash_attention_block_stats"), ("ulysses", "flash_attention_forward")):
            sp = MMDiT(MMDiTConfig(**T2I_MEDIUM, compute_dtype=bf16, attention=attention), mesh=mesh, device=dev,
                       generator=gen, dtype=bf16)
            sp.load_state_dict(flash.state_dict())
            sp.requires_grad_(False)
            _reset_counters()
            got = sp(x, t, ctx)
            counts = _counters()
            expected = {**per_forward, kernel: joint, "flash_attention_pairs_forward": 0}
            median = _median_step_ms(lambda _i: sp(x, t, ctx), 5)
            rel = _relative(got, want)
            print(
                f"t2i 18b: MMDiT attention={attention!r} on the one-rank mesh: one forward launched {counts}; against "
                f"flash relative max err {rel:.3e} (tolerance 5e-2); median {median[0]:.2f} ms (min {median[1]:.2f}, "
                f"max {median[2]:.2f}; {card})"
            )
            expect(counts == expected, f"t2i 18b: the {attention} MMDiT launched {counts}, expected {expected}")
            expect(bool(torch.isfinite(got).all()) and rel <= 5e-2, f"t2i 18b: the {attention} MMDiT differs by {rel}")
            for name, count in counts.items():
                total[name] += count
            del sp, got
    del flash, want
    gc.collect()
    torch.cuda.empty_cache()


def t2i_parallel_phase(card: str) -> dict[str, int]:
    """Phase 18: (a) the text-to-image trainer (``train_text_to_image.t2i_train_step``) at SD3.5-medium's widths in
    the native wiring (MMDiT dim 1536, 24 blocks of 24 heads of 64, patch 2, 16 channels, qk-norm, dual attention in
    blocks 0-12, 128 context tokens of 768, ``"flash"``, bf16 compute, f32 masters) with the TextEncoder at CLIP-L's
    widths (768, 12 blocks, 12 heads, causal, the byte vocabulary): batch 4 of 64x64 latents, 20 steps of AdamW 1e-4
    with CFG dropout 0.1; the parameter count, the step time, the peak memory, the loss falling, exact K3/K6/B7/B10
    launches a step, one step against the plain versions, and one traced step.  (b) On a one-rank NCCL group,
    ``make_mesh(dp=1, sp=1)``: ``ServingEngine(mesh=)`` (eager and ``graph=True``), ``ContinuousServingEngine(mesh=)``
    and ``GenerationPipeline(mesh=)`` over phase 3's DiT-512/8, ``VideoDiT(sequence_parallel=True)`` at phase 10's
    widths, one ``--dp 1`` step of each trainer, each bit for bit its mesh-less twin; and the SD3.5-medium-width
    MMDiT with ``attention="ring"`` and ``"ulysses"`` against ``"flash"``."""
    import torch
    import torch.distributed as dist

    from skrample_tpu_torch.parallel import make_mesh

    phase_t0 = time.perf_counter()
    print(f"t2i: phase starts with {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card")
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    t0 = time.perf_counter()
    _t2i_trainer_part(card, total)
    print(f"t2i 18a: took {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    torch.cuda.set_device(dev)  # the mesh's communicators take the current device
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(str(Path(tmp) / "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh(dp=1, sp=1)
            _mesh_engines_part(card, mesh, total)
            _mesh_models_part(card, mesh, total)
        finally:
            dist.destroy_process_group()
    print(f"t2i 18b: took {time.perf_counter() - t0:.1f} s")
    print(f"t2i: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


TP_FLUX_STEPS = 4  # 19a: a FLUX.1-dev request at 1024x1024 cut to 4 steps (phase 6 serves 28)
FSDP_STEPS = 3  # 19b: DiT-512/8 steps at --dp 2 with and without --fsdp


TWIN_TIMED = 3  # 19a: timed runs of each twin after its counted one (their median)
TP_WORLD = 2  # 19b: the tensor-parallel world's processes, both on the one card
GRAPH_STEPS = 3  # 19a: GraphedTrainStep calls a twin (the eager warm-up, then two replays)


def _flux_dev_config():
    "FLUX.1-dev's published widths and depth in bf16 with the flash attention (phases 19a and 19b)."
    import torch

    from skrample_tpu_torch.models.flux import FluxConfig

    return FluxConfig(
        dim=3072, heads=24, depth=19, single_depth=38, context_dim=4096, pooled_dim=768, guidance=True,
        compute_dtype=torch.bfloat16, attention="flash",
    )


def _flux_dev(mesh, dev):
    """FLUX.1-dev in bf16 on ``mesh`` (None: unsharded), its weights drawn on the card from seed 0 with
    ``noise=0.02``: under ``tp`` each rank draws every layer whole and keeps its part, so the shards are the
    unsharded model's."""
    import torch

    from skrample_tpu_torch.models.flux import Flux

    gen = torch.Generator(dev).manual_seed(0)
    flux = Flux(_flux_dev_config(), mesh=mesh, device=dev, generator=gen, dtype=torch.bfloat16)
    flux.reset_parameters(gen, noise=0.02)
    return flux.requires_grad_(False)


def _flux_dev_inputs(dev) -> tuple[tuple, dict]:
    "One 1024x1024 FLUX.1-dev forward's inputs (4096 image and 512 text tokens), from seed 1 on the card."
    import torch

    gen = torch.Generator(dev).manual_seed(1)
    ctx = torch.randn((1, 512, 4096), generator=gen, device=dev)
    pooled = torch.randn((1, 768), generator=gen, device=dev)
    x = torch.randn((1, 16, 128, 128), generator=gen, device=dev)
    return (x, torch.tensor([0.7], device=dev), ctx, pooled), {"guidance": torch.tensor([3.5], device=dev)}


def _counted(run) -> tuple[list, dict[str, int], list[float]]:
    """``run()`` once to warm it, once with the counters from 0, then ``TWIN_TIMED`` times on the host clock
    ending in a synchronize: (the counted run's outputs, its launches, the timed runs' ms)."""
    import torch

    run()
    torch.cuda.synchronize()
    _reset_counters()
    got = run()
    torch.cuda.synchronize()
    counts = _counters()
    times = []
    for _ in range(TWIN_TIMED):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (got if isinstance(got, list) else [got]), counts, times


def _twin_check(label: str, results: dict, card: str, total: dict[str, int]) -> None:
    """19a: the mesh twin's :func:`_counted` result (``True``) equal to the mesh-less one's bit for bit, with the
    same launches; the mesh twin's counts go to ``total``."""
    (outs, counts, ms), (twin_outs, twin_counts, twin_ms) = results[True], results[False]
    same, err = _same(outs, twin_outs)
    spread = {k: f"{statistics.median(v):.2f} ms ({min(v):.2f}-{max(v):.2f})" for k, v in (("mesh", ms), ("none", twin_ms))}
    print(
        f"tp 19a: {label}: bit-equal {same} (max abs diff {err:.3e}) to its mesh-less twin, launches "
        f"{ {k: v for k, v in counts.items() if v} } (mesh-less: equal {counts == twin_counts}); median of "
        f"{TWIN_TIMED}: {spread['mesh']} with the mesh, {spread['none']} without ({card})"
    )
    expect(same, f"tp 19a: {label} differs from its mesh-less twin by {err}")
    expect(counts == twin_counts, f"tp 19a: {label} launched {counts}, its twin {twin_counts}")
    expect(any(counts.values()), f"tp 19a: {label} launched no kernel")
    for name, count in counts.items():
        total[name] += count


def _twins(label: str, runs: dict, card: str, total: dict[str, int]) -> None:
    "19a: :func:`_counted` for each twin in ``runs`` (``True``: the mesh one), then :func:`_twin_check`."
    _twin_check(label, {m: _counted(run) for m, run in runs.items()}, card, total)


def _tp_twins_part(card: str, mesh, total: dict[str, int]) -> None:
    """19a: each path on the one-rank ``(dp 1, sp 1, tp 1)`` NCCL mesh against its mesh-less twin."""
    import gc

    import torch

    from skrample_tpu_torch import prng, scheduling
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
    from skrample_tpu_torch.models.ema import ema_init
    from skrample_tpu_torch.models.flux import Flux
    from skrample_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from skrample_tpu_torch.models.sdxl import SDXLStack
    from skrample_tpu_torch.models.unet_cond import CondUNet, CondUNetConfig
    from skrample_tpu_torch.parallel import make_mesh
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine
    from skrample_tpu_torch.train_text_to_image import build_models, hermetic_data, t2i_draws, t2i_optimizer, t2i_train_step
    from skrample_tpu_torch.training import GraphedTrainStep, draw_batch, make_optimizer, synthetic_dataset

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16

    # ---- DiT-512/8 through ServingEngine(mesh=) ----
    config = DiTConfig(dim=512, depth=DEPTH, heads=4, channels=4, compute_dtype=bf16, attention="flash")
    tree = random_param_tree(config, seed=0)
    dits = {m: DiT(config, mesh=mesh if m else None, device=dev).load_jax_params(tree).requires_grad_(False)
            for m in (False, True)}
    with contextlib.ExitStack() as stack:
        engines = {
            m: stack.enter_context(ServingEngine(
                dits[m].as_sampleable(), item_shape=(4, 64, 64), steps=STEPS, buckets=(1, 2), max_delay_ms=50.0,
                mesh=mesh if m else None, device=dev,
            ))
            for m in (False, True)
        }

        def served(engine) -> list:
            pair = [engine.submit(s) for s in MESH_REQUESTS[:2]]
            return [f.result() for f in pair] + [engine.generate(MESH_REQUESTS[2])]

        _twins("ServingEngine(mesh=dp 1 x tp 1) over DiT-512/8, 3 requests", {m: (lambda e=e: served(e)) for m, e in engines.items()},
               card, total)
    del dits, engines

    # ---- FLUX.1-dev: one bf16 request, then one int8 forward ----
    f_config = _flux_dev_config()
    flux = _flux_dev(None, dev)
    flux_tp = Flux(f_config, mesh=mesh, device=dev, generator=torch.Generator(dev).manual_seed(1), dtype=bf16)
    flux_tp.load_state_dict(flux.state_dict())
    fluxes = {False: flux.requires_grad_(False), True: flux_tp.requires_grad_(False)}
    cgen = torch.Generator(dev).manual_seed(1)
    ctx = (torch.randn((512, 4096), generator=cgen, device=dev), torch.randn((768,), generator=cgen, device=dev))
    with contextlib.ExitStack() as stack:
        engines = {
            m: stack.enter_context(ServingEngine(
                fluxes[m].as_served(guidance=3.5), item_shape=(16, 128, 128), sampler=structured.DPM(order=2),
                schedule=scheduling.FlowShift(scheduling.Linear()), model_transform=models.FlowModel(),
                steps=TP_FLUX_STEPS, buckets=(1,), conditioned=True, device=dev,
            ))
            for m in (False, True)
        }
        _twins(f"FLUX.1-dev (tp 1) bf16 request, 1024x1024 at {TP_FLUX_STEPS} steps",
               {m: (lambda e=e: e.generate(SEEDS[0], context=ctx)) for m, e in engines.items()}, card, total)
    del engines, flux, flux_tp
    args, kwargs = _flux_dev_inputs(dev)
    results = {}
    with torch.inference_mode():
        for m in (False, True):  # one int8 copy at a time, the mesh-less model freed before the mesh one's
            q = fluxes[m].quantize_params()
            results[m] = _counted(lambda q=q: q(*args, **kwargs))
            del q
            if not m:
                del fluxes[m]
                gc.collect()
                torch.cuda.empty_cache()
    _twin_check("FLUX.1-dev (tp 1) int8 forward, 4608 tokens", results, card, total)
    del fluxes, results
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the SD3.5-medium-width MMDiT at tp x sp ring, against the ring without a tp axis ----
    gen = torch.Generator(dev).manual_seed(181)
    ring_cfg = MMDiTConfig(**T2I_MEDIUM, compute_dtype=bf16, attention="ring")
    mm = {m: MMDiT(ring_cfg, mesh=mesh if m else make_mesh(dp=1, sp=1), device=dev, generator=gen, dtype=bf16)
          for m in (False, True)}
    mm[False].reset_parameters(gen, noise=0.02)
    mm[True].load_state_dict(mm[False].state_dict())
    x = torch.randn((2, 16, T2I_SIZE, T2I_SIZE), generator=gen, device=dev)
    tt = torch.tensor([500.0, 20.0], device=dev)
    mctx = torch.randn((2, 128, T2I_MEDIUM["context_dim"]), generator=gen, device=dev)
    with torch.inference_mode():
        _twins("SD3.5-medium-width MMDiT, ring at tp 1 x sp 1 (twin: ring at sp 1, no tp axis)",
               {m: (lambda model=model.requires_grad_(False): model(x, tt, mctx)) for m, model in mm.items()}, card, total)
    del mm
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one CFG forward of the SDXL CondUNet ----
    u_cfg = CondUNetConfig(compute_dtype=bf16)
    gen = torch.Generator(dev).manual_seed(0)
    unet = CondUNet(u_cfg, device=dev, generator=gen, dtype=bf16)
    unet.reset_parameters(gen, noise=0.02)
    unet_tp = CondUNet(u_cfg, device=dev, generator=torch.Generator(dev).manual_seed(1), dtype=bf16, mesh=mesh)
    unet_tp.load_state_dict(unet.state_dict())
    cgen = torch.Generator(dev).manual_seed(1)
    cond, uncond = ((torch.randn((77, u_cfg.context_dim), generator=cgen, device=dev),
                     torch.randn((u_cfg.pooled_dim,), generator=cgen, device=dev)) for _ in range(2))
    time_ids = SDXLStack.time_ids((1024, 1024), (0, 0), (1024, 1024), device=dev)
    x = torch.randn((1, 4, 128, 128), generator=cgen, device=dev)
    fns = {m: u.requires_grad_(False).as_sampleable(cond[0], cond[1], time_ids, 5.0, uncond[0], uncond[1])
           for m, u in ((False, unet), (True, unet_tp))}
    with torch.inference_mode():
        _twins("SDXL base CondUNet (tp 1), one CFG 5.0 forward at 1024x1024",
               {m: (lambda fn=fn: fn(x, torch.tensor([500.0], device=dev), None, None)) for m, fn in fns.items()}, card, total)
    del unet, unet_tp, fns
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one train_text_to_image --tp 1 step ----
    ids, images = hermetic_data(16, device=dev)
    draws = t2i_draws(prng.PRNGKey(2), 8, 16, 0.1, device=dev)

    def t2i_step(meshed: bool) -> list:
        enc, mmd = build_models(128, dev, mesh if meshed else None)
        loss = t2i_train_step(enc, mmd, t2i_optimizer(enc, mmd), ids, images, draws, mesh if meshed else None)
        return [loss, *(p.detach().clone() for mod in (enc, mmd) for p in mod.parameters())]

    _twins("train_text_to_image --tp 1: one joint step at the example's widths (dim 128)",
           {m: (lambda m=m: t2i_step(m)) for m in (False, True)}, card, total)

    # ---- training --dp 1 --graph: GraphedTrainStep(mesh=) captures the step's collectives ----
    data = synthetic_dataset(64, dev)

    def graphed_steps(meshed: bool) -> list:
        "DiT-512/8: the eager warm-up step and capture, then two replays; the losses and the parameters."
        model = DiT(config, mesh=mesh if meshed else None, device=dev).load_jax_params(tree)
        step = GraphedTrainStep(model, make_optimizer(model, capturable=True), ema_init(model),
                                mesh=mesh if meshed else None)
        gen = torch.Generator(dev).manual_seed(7)
        losses = [step(*draw_batch(data, 4, gen)).clone() for _ in range(GRAPH_STEPS)]
        return [*losses, *(p.detach().clone() for p in model.parameters())]

    results = {}
    for m in (False, True):  # one counted run a twin: each builds its model and captures its graph
        _reset_counters()
        t0 = time.perf_counter()
        outs = graphed_steps(m)
        torch.cuda.synchronize()
        results[m] = (outs, _counters(), [(time.perf_counter() - t0) * 1e3])
    _twin_check(f"training --dp 1 --graph: {GRAPH_STEPS} DiT-512/8 steps (batch 4 of 4x64x64; the first eager, "
                "then the captured graph's replays), parameters and losses", results, card, total)


def _tp_world_rank(rank: int, store_path: str, queue) -> None:
    """19b: one rank of a gloo world of ``TP_WORLD`` processes, all on ``cuda:0``, on a ``(dp 1, sp 1, tp
    TP_WORLD)`` mesh: DiT-512/8's bf16 forward cut over ``tp`` and its unsharded twin on this rank, then
    FLUX.1-dev's int8 forward cut over ``tp`` (:func:`_flux_dev`, quantized from the rank's shards, the bf16
    model freed before the forward).  Puts ``(rank, result)`` on ``queue``: the outputs on the host, each
    forward's launches, and the peak memory this process allocated from FLUX.1-dev's build to its output;
    ``(rank, traceback)`` on a failure."""
    import gc
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    try:
        from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
        from skrample_tpu_torch.parallel import make_mesh

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, TP_WORLD)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=TP_WORLD, timeout=timedelta(seconds=300))
        try:
            mesh = make_mesh(dp=1, sp=1, extra_axes={"tp": TP_WORLD})
            out: dict = {}
            config = DiTConfig(dim=512, depth=DEPTH, heads=4, channels=4, compute_dtype=torch.bfloat16,
                               attention="flash")
            tree = random_param_tree(config, seed=0)
            gen = torch.Generator(dev).manual_seed(2)
            x, t = torch.randn((2, 4, 64, 64), generator=gen, device=dev), torch.tensor([700.0, 30.0], device=dev)
            with torch.inference_mode():
                for meshed in (True, False):
                    model = DiT(config, mesh=mesh if meshed else None, device=dev).load_jax_params(tree)
                    _reset_counters()
                    y = model.requires_grad_(False)(x, t)
                    torch.cuda.synchronize()
                    out["dit" if meshed else "dit_twin"] = y.float().cpu().numpy()  # numpy: pickled by value
                    if meshed:
                        out["dit_counts"] = _counters()
                    del model
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            flux = _flux_dev(mesh, dev)
            out["flux_bf16_bytes"] = sum(p.numel() * p.element_size() for p in flux.parameters())
            args, kwargs = _flux_dev_inputs(dev)
            with torch.inference_mode():
                q = flux.quantize_params()
                del flux
                _reset_counters()
                y = q(*args, **kwargs)
                torch.cuda.synchronize()
            out["flux_counts"] = _counters()
            out["flux"] = y.float().cpu().numpy()
            out["flux_peak"] = torch.cuda.max_memory_allocated(dev) - base
            queue.put((rank, out))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


def _tp_world_part(card: str, total: dict[str, int]) -> None:
    """19b: :func:`_tp_world_rank` on ``TP_WORLD`` spawned processes; then, in this process, FLUX.1-dev's
    unsharded int8 forward on the same weights and inputs.  Each rank's DiT-512/8 forward within 5e-2 relative
    max of its unsharded twin (bf16: the row-parallel layers add their float32 partial sums over ``tp``
    before one rounding, the unsharded ones round one sum), every rank's FLUX.1-dev int8 output equal to the
    unsharded one bit for bit (int32 sums over ``tp`` are exact), and each rank's peak memory beside the
    unsharded model's."""
    import gc
    import multiprocessing
    import queue as queues

    import torch

    ctx = multiprocessing.get_context("spawn")
    results: dict[int, dict] = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        channel = ctx.Queue()
        procs = [ctx.Process(target=_tp_world_rank, args=(r, f"{tmp}/store", channel), daemon=True)
                 for r in range(TP_WORLD)]
        try:
            for proc in procs:
                proc.start()
            while len(results) < TP_WORLD:
                try:
                    rank, got = channel.get(timeout=600)
                except queues.Empty:
                    raise SmokeFailure("tp 19b world: no result from a rank within 600 s") from None
                expect(isinstance(got, dict), f"tp 19b world: rank {rank} failed:\n{got}")
                results[rank] = {k: torch.from_numpy(v) if hasattr(v, "dtype") else v for k, v in got.items()}
            for proc in procs:
                proc.join(timeout=60)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
    world_s = time.perf_counter() - t0
    expect([p.exitcode for p in procs] == [0] * TP_WORLD, f"tp 19b world: exit codes {[p.exitcode for p in procs]}")
    for rank, got in results.items():
        err = _relative(got["dit"], got["dit_twin"])
        print(
            f"tp 19b rank {rank}: DiT-512/8 bf16 forward (batch 2 of 4x64x64) at tp {TP_WORLD} (2 heads a rank) vs "
            f"its unsharded twin: relative max err {err:.3e} (tolerance 5e-2), launches "
            f"{ {k: v for k, v in got['dit_counts'].items() if v} } ({card})"
        )
        finite = bool(torch.isfinite(got["dit"]).all())
        expect(finite and err <= 5e-2, f"tp 19b rank {rank}: DiT at tp differs by {err} (finite {finite})")
        expect(got["dit_counts"]["flash_attention_qkv_forward"] > 0, f"tp 19b rank {rank}: the DiT launched no K2")
        for name in ("dit_counts", "flux_counts"):
            for k, v in got[name].items():
                total[k] += v
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    flux = _flux_dev(None, dev)
    whole_bytes = sum(p.numel() * p.element_size() for p in flux.parameters())
    args, kwargs = _flux_dev_inputs(dev)
    with torch.inference_mode():
        q = flux.quantize_params()
        del flux
        _reset_counters()
        want = q(*args, **kwargs).float().cpu()
        torch.cuda.synchronize()
    counts = _counters()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del q
    gc.collect()
    torch.cuda.empty_cache()
    for rank, got in results.items():
        same, err = _same([got["flux"]], [want])
        print(
            f"tp 19b rank {rank}: FLUX.1-dev int8 forward (4608 tokens) at tp {TP_WORLD} (12 heads a rank): bit-equal "
            f"{same} (max abs diff {err:.3e}) to the unsharded int8 forward; bf16 parameters "
            f"{got['flux_bf16_bytes'] / 2**30:.2f} GiB a rank against {whole_bytes / 2**30:.2f} unsharded; peak memory "
            f"from the build to the output {got['flux_peak'] / 2**30:.2f} GiB a rank against "
            f"{peak / 2**30:.2f} unsharded; launches {_nonzero(got['flux_counts'])} (unsharded "
            f"{_nonzero(counts)}) ({card})"
        )
        expect(same, f"tp 19b rank {rank}: FLUX.1-dev int8 at tp differs from unsharded by {err}")
        expect(got["flux_counts"]["quantize_rows"] > 0, f"tp 19b rank {rank}: FLUX.1-dev int8 launched no B6")
    print(f"tp 19b world: {TP_WORLD} processes took {world_s:.1f} s, the unsharded forward "
          f"{time.perf_counter() - t0 - world_s:.1f} s ({card})")


def _nonzero(counts: dict[str, int]) -> dict[str, int]:
    return {k: v for k, v in counts.items() if v}


def _fsdp_runs_part(card: str) -> None:
    """19b: two processes on the one card over gloo (both on ``cuda:0``): DiT-512/8 at ``--dp 2`` with and without
    ``--fsdp``, AdamW and ``--opt8``, bit for bit; then phase 15c's DiT-512/2 killed and resumed at ``--dp 2 --fsdp
    --opt8`` against an uninterrupted run, bit for bit."""
    import threading

    import torch

    from skrample_tpu_torch.models import _tree
    from skrample_tpu_torch.models.checkpoint import load_params
    from skrample_tpu_torch.parallel.dryrun import spawn_cli

    with tempfile.TemporaryDirectory() as tmp:

        def together(argvs: dict[str, list[str]]) -> dict[str, list]:
            "Each argv on its own two-rank world, the worlds at once (threads waiting on spawned ranks)."
            codes: dict[str, list] = {}
            threads = [threading.Thread(target=lambda k=k, a=a: codes.__setitem__(k, spawn_cli(2, a, tmp, 300)))
                       for k, a in argvs.items()]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            return codes

        def tree(name: str) -> dict:
            return dict(_tree._flatten(load_params(f"{tmp}/{name}.npz")))

        base = ["--device", "cuda", "--dp", "2", "--steps", str(FSDP_STEPS), "--dim", "512", "--depth", str(DEPTH),
                "--heads", "4", "--size", "64", "--batch", "4"]
        resume = ["--device", "cuda", "--dim", "512", "--heads", "4", "--depth", "2", "--host-loader", "--dp", "2",
                  "--fsdp", "--opt8", "--until", str(RESUME_UNTIL), "--save-every", str(RESUME_EVERY)]
        runs = {
            f"{name}{tag}": [*base, *opt, *extra, "--checkpoint", f"{tmp}/{name}{tag}.npz"]
            for tag, opt in (("", []), ("8", ["--opt8"])) for name, extra in (("dp", []), ("fsdp", ["--fsdp"]))
        }
        runs["straight"] = [*resume, "--orbax", f"{tmp}/straight", "--checkpoint", f"{tmp}/straight.npz"]
        runs["killed"] = [*resume, "--orbax", f"{tmp}/killed", "--abort-after-step", str(RESUME_ABORT)]
        t0 = time.perf_counter()
        codes = together(runs)  # six two-rank worlds at once, twelve processes on the card
        first_stage = time.perf_counter() - t0
        for tag, label in (("", "AdamW"), ("8", "--opt8")):
            expect(codes[f"dp{tag}"] == codes[f"fsdp{tag}"] == [0, 0], f"tp 19b {label}: the runs exited {codes}")
            a, b = tree(f"dp{tag}"), tree(f"fsdp{tag}")
            same = a.keys() == b.keys() and all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)
            first = next((k for k in a if not torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))), None)
            whole = sum(v.nbytes for v in a.values())
            print(
                f"tp 19b {label}: {FSDP_STEPS} DiT-512/8 steps (batch 4 of 4x64x64, bf16) at --dp 2 --fsdp against "
                f"--dp 2, two gloo ranks on one card: parameters bit-equal {same} (first differing leaf {first}); "
                f"the replicated parameters {whole} bytes a rank ({card})"
            )
            expect(same, f"tp 19b {label}: --fsdp differs from --dp 2 first at {first}")
        t0 = time.perf_counter()
        codes.update(together({"resumed": [*resume, "--orbax", f"{tmp}/killed", "--resume",
                                           "--checkpoint", f"{tmp}/resumed.npz"]}))
        print(f"tp 19b: the six first worlds took {first_stage:.1f} s together, the resumed one "
              f"{time.perf_counter() - t0:.1f} s ({card})")
        want = {"straight": [0, 0], "killed": [-9, -9], "resumed": [0, 0]}
        got = {k: codes[k] for k in want}
        expect(got == want, f"tp 19b resume: the runs exited {got}, expected {want}")
        a, b = tree("straight"), tree("resumed")
        same = a.keys() == b.keys() and all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)
        states = {}
        for rank in range(2):
            sa = torch.load(f"{tmp}/straight/{RESUME_UNTIL}/state-{rank}.pt", weights_only=True)
            sb = torch.load(f"{tmp}/killed/{RESUME_UNTIL}/state-{rank}.pt", weights_only=True)
            fa, fb = _flat_tensors(sa), _flat_tensors(sb)
            states[rank] = fa.keys() == fb.keys() and _same(list(fa.values()), list(fb.values()))[0]
        print(
            f"tp 19b resume: DiT-512/2 --dp 2 --fsdp --opt8 killed after step {RESUME_ABORT} (SIGKILL on both ranks), "
            f"resumed to step {RESUME_UNTIL}, against an uninterrupted run: whole parameters bit-equal {same}, each "
            f"rank's sharded state bit-equal {states} ({card})"
        )
        expect(same and all(states.values()), f"tp 19b resume: differs (parameters {same}, states {states})")


def tp_fsdp_phase(card: str) -> dict[str, int]:
    """Phase 19: tensor parallelism and FSDP.  (a) On a one-rank NCCL group, ``make_mesh(dp=1, sp=1,
    extra_axes={"tp": 1})``: ``ServingEngine(mesh=)`` over DiT-512/8, a FLUX.1-dev bf16 request and one int8
    forward, the SD3.5-medium-width MMDiT's ring at tp 1 x sp 1, one CFG forward of SDXL base's CondUNet, one
    ``train_text_to_image --tp 1`` step and three ``--dp 1 --graph`` steps, each bit for bit its mesh-less twin
    with the same launches.  (b) Two processes on the card over gloo: the tp 2 world (:func:`_tp_world_part`),
    ``--dp 2 --fsdp`` against ``--dp 2`` (AdamW and ``--opt8``) and the ``--fsdp --opt8`` kill-and-resume."""
    import torch
    import torch.distributed as dist

    from skrample_tpu_torch.parallel import make_mesh

    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(str(Path(tmp) / "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
        try:
            _tp_twins_part(card, make_mesh(dp=1, sp=1, extra_axes={"tp": 1}), total)
        finally:
            dist.destroy_process_group()
    print(f"tp 19a: took {time.perf_counter() - phase_t0:.1f} s")
    t0 = time.perf_counter()
    _tp_world_part(card, total)
    _fsdp_runs_part(card)
    print(f"tp 19b: took {time.perf_counter() - t0:.1f} s")
    print(f"tp: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


# phase 20: the pipeline stages (pp), the gradient through the ring and ulysses, the experts and the utilities
PP_WORLD = 2  # 20a/20b: the world of pipeline stages (then of sp 2), both processes on the one card
PP_BATCH = 4  # 20a: DiT-512/8's batch of 4x64x64, streamed in microbatches of 1 and of 2
PP_SIZE = 64  # 20a-20c: DiT-512/8's latent size
PP_MMDIT = {**T2I_MEDIUM, "depth": 4, "dual_attention_layers": ()}  # SD3.5-medium's widths, uniform blocks, cut to 4
MOE_WIDTHS = {"dim": 256, "hidden": 1024, "experts": 8, "tokens": 2048}  # scripts/bench_moe.py's D, H, an E and a T
TRACE_REQUEST_STEPS = 4  # 20c: the traced DiT-512/8 request's steps


def _flow_loss(forward, x0, noise, sigma):
    "The trainer's flow-matching loss of ``forward(x_t, 1000 sigma)`` (float32)."
    s = sigma[:, None, None, None]
    return ((forward((1 - s) * x0 + s * noise, sigma * 1000.0).float() - (noise - x0)) ** 2).mean()


def _grad_err(got: dict, want: dict) -> float:
    "The largest relative max error over the gradients ``got`` holds (by name), each against ``want``'s."
    return max(_relative(g, want[name]) for name, g in got.items())


def _pp_world_rank(rank: int, store_path: str, queue) -> None:
    """20a and the gloo half of 20b: one rank of a gloo world of ``PP_WORLD`` processes on ``cuda:0``.  On a
    ``(1, 1, pp PP_WORLD)`` mesh: DiT-512/8's pipelined forward (microbatch 1 and 2) and its ``apply``, one
    training step's loss and gradients through the stage hops and the same step unpipelined, the uniform
    SD3.5-medium-width MMDiT's pipelined forward and its ``apply``; then on a ``(1, sp PP_WORLD)`` mesh one
    ring and one ulysses DiT-512/8 ``training.train_step`` (their shares summed over ``sp`` by the step)
    beside the flash DiT's loss and gradients.  Puts ``(rank, result)`` on ``queue`` (host numbers and each
    part's launches), ``(rank, traceback)`` on a failure."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    try:
        from skrample_tpu_torch.models.dit import DiT
        from skrample_tpu_torch.models.ema import ema_init
        from skrample_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
        from skrample_tpu_torch.parallel import make_mesh
        from skrample_tpu_torch.training import make_optimizer, train_step

        dev, sync = torch.device("cuda", 0), torch.cuda.synchronize
        torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, PP_WORLD)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=PP_WORLD, timeout=timedelta(seconds=300))
        try:
            out: dict = {}
            pp = make_mesh(dp=1, sp=1, extra_axes={"pp": PP_WORLD})
            config, tree = _dit512()
            model = DiT(config, device=dev).load_jax_params(tree)
            gen = torch.Generator(dev).manual_seed(20)
            x = torch.randn((PP_BATCH, 4, PP_SIZE, PP_SIZE), generator=gen, device=dev)
            t = torch.linspace(10.0, 900.0, PP_BATCH, device=dev)
            t0 = time.perf_counter()
            with torch.inference_mode():
                want = model(x, t)
                for mb in (1, 2):
                    _reset_counters()
                    got = model.apply_pipelined(x, t, pp, mb)
                    sync()
                    out[f"pp{mb}"] = (_relative(got, want), bool(torch.isfinite(got).all()), _counters())
            x0, noise = (torch.randn((PP_BATCH, 4, PP_SIZE, PP_SIZE), generator=gen, device=dev) for _ in range(2))
            sigma = torch.rand((PP_BATCH,), generator=gen, device=dev) * 0.998 + 1e-3
            _reset_counters()
            loss = _flow_loss(lambda a, b: model.apply_pipelined(a, b, pp, 2), x0, noise, sigma)
            loss.backward()
            sync()
            counts = _counters()
            grads = {n: p.grad.float().clone() for n, p in model.named_parameters() if p.grad is not None}
            model.zero_grad(set_to_none=True)
            twin = _flow_loss(model, x0, noise, sigma)
            twin.backward()
            want_grads = {n: p.grad.float() for n, p in model.named_parameters()}
            out["train"] = (float(loss.detach()), float(twin.detach()), _grad_err(grads, want_grads), len(grads), counts)
            del model, grads, want_grads
            bf16 = torch.bfloat16
            mm_gen = torch.Generator(dev).manual_seed(201)
            mm = MMDiT(MMDiTConfig(**PP_MMDIT, compute_dtype=bf16, attention="flash"), device=dev, generator=mm_gen,
                       dtype=bf16)
            mm.reset_parameters(mm_gen, noise=0.02)
            mm.requires_grad_(False)
            mx = torch.randn((PP_BATCH, PP_MMDIT["channels"], T2I_SIZE, T2I_SIZE), generator=mm_gen, device=dev)
            ctx = torch.randn((PP_BATCH, PP_MMDIT["context_tokens"], PP_MMDIT["context_dim"]), generator=mm_gen,
                              device=dev)
            with torch.inference_mode():
                want = mm(mx, t, ctx)
                _reset_counters()
                got = mm.apply_pipelined(mx, t, pp, 2, context=ctx)
                sync()
                out["mmdit"] = (_relative(got, want), bool(torch.isfinite(got).all()), _counters())
            del mm
            out["pp_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()  # 20b: sp = the world, one ring and one ulysses step beside the flash loss
            sp = make_mesh(dp=1, sp=PP_WORLD)
            flash = DiT(config, device=dev).load_jax_params(tree)
            want_loss = _flow_loss(flash, x0, noise, sigma)
            want_loss.backward()
            want_grads = {n: p.grad.float() for n, p in flash.named_parameters()}
            del flash
            for attention in ("ring", "ulysses"):
                model = DiT(dataclasses.replace(config, attention=attention), mesh=sp, device=dev)
                model.load_jax_params(tree)
                opt, ema = make_optimizer(model), ema_init(model)
                _reset_counters()
                loss = train_step(model, opt, ema, x0, noise, sigma, 0, mesh=sp)
                sync()
                got = {n: p.grad.float() for n, p in model.named_parameters()}  # the step leaves its gradients
                finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in got.values())
                out[f"sp_{attention}"] = (float(loss.detach()), float(want_loss.detach()), _grad_err(got, want_grads), finite,
                                          _counters())
                del model, got
            out["sp_s"] = time.perf_counter() - t0
            queue.put((rank, out))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


def _pp_world_part(card: str, total: dict[str, int]) -> None:
    """20a and 20b's gloo half: :func:`_pp_world_rank` on ``PP_WORLD`` spawned processes, each rank's results
    checked: the pipelined forwards and the pipelined step within 5e-2 relative max of their twins (bf16: the
    microbatches' kernels tile other batch sizes), the ring and ulysses steps finite and within 5e-2 of the
    flash step's loss and gradients."""
    import multiprocessing
    import queue as queues

    ctx = multiprocessing.get_context("spawn")
    results: dict[int, dict] = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        channel = ctx.Queue()
        procs = [ctx.Process(target=_pp_world_rank, args=(r, f"{tmp}/store", channel), daemon=True)
                 for r in range(PP_WORLD)]
        try:
            for proc in procs:
                proc.start()
            while len(results) < PP_WORLD:
                try:
                    rank, got = channel.get(timeout=600)
                except queues.Empty:
                    raise SmokeFailure("pp 20a world: no result from a rank within 600 s") from None
                expect(isinstance(got, dict), f"pp 20a world: rank {rank} failed:\n{got}")
                results[rank] = got
            for proc in procs:
                proc.join(timeout=60)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
    expect([p.exitcode for p in procs] == [0] * PP_WORLD, f"pp 20a world: exit codes {[p.exitcode for p in procs]}")
    for rank, got in sorted(results.items()):
        for mb in (1, 2):
            err, finite, counts = got[f"pp{mb}"]
            print(f"pp 20a rank {rank}: DiT-512/8 apply_pipelined at pp {PP_WORLD}, batch {PP_BATCH} in microbatches of "
                  f"{mb}, against apply: relative max err {err:.3e} (tolerance 5e-2), launches {_nonzero(counts)} ({card})")
            expect(finite and err <= 5e-2, f"pp 20a rank {rank}: the pipelined DiT (microbatch {mb}) differs by {err}")
            expect(counts["flash_attention_qkv_forward"] > 0 and counts["adaln_forward"] > 0,
                   f"pp 20a rank {rank}: the pipelined DiT launched {counts}")
        loss, twin, err, held, counts = got["train"]
        rel = abs(loss - twin) / abs(twin)
        print(f"pp 20a rank {rank}: one DiT-512/8 training step through the stage hops (microbatch 2): loss {loss:.6f} "
              f"against the unpipelined {twin:.6f} (relative {rel:.3e}), the {held} gradients this rank holds within "
              f"{err:.3e} relative max of the unpipelined ones (tolerance 5e-2), launches {_nonzero(counts)} ({card})")
        expect(rel <= 5e-2 and err <= 5e-2, f"pp 20a rank {rank}: the pipelined step differs (loss {rel}, grads {err})")
        expect(all(counts[k] > 0 for k in ("flash_attention_qkv_forward_lse", "flash_attention_qkv_backward",
                                            "adaln_forward", "adaln_backward")),
               f"pp 20a rank {rank}: the pipelined step launched {counts}")
        err, finite, counts = got["mmdit"]
        print(f"pp 20a rank {rank}: the SD3.5-medium-width MMDiT (uniform blocks, depth {PP_MMDIT['depth']}) "
              f"apply_pipelined at pp {PP_WORLD}, microbatch 2, against apply: relative max err {err:.3e} (tolerance "
              f"5e-2), launches {_nonzero(counts)} ({card})")
        expect(finite and err <= 5e-2, f"pp 20a rank {rank}: the pipelined MMDiT differs by {err}")
        for attention, kernel in (("ring", "flash_attention_block_stats"), ("ulysses", "flash_attention_forward")):
            loss, want, err, finite, counts = got[f"sp_{attention}"]
            rel = abs(loss - want) / abs(want)
            print(f"sp 20b rank {rank}: one DiT-512/8 train_step, attention={attention!r} at sp {PP_WORLD} (gloo): "
                  f"loss {loss:.6f} against flash {want:.6f} (relative {rel:.3e}), gradients within {err:.3e} relative "
                  f"max (tolerance 5e-2), finite {finite}, launches {_nonzero(counts)} ({card})")
            expect(finite and rel <= 5e-2 and err <= 5e-2, f"sp 20b rank {rank}: the {attention} step differs")
            expect(counts[kernel] > 0, f"sp 20b rank {rank}: the {attention} step launched no {kernel}")
        for part in ("pp1", "pp2", "mmdit", "train", "sp_ring", "sp_ulysses"):
            for k, v in got[part][-1].items():
                total[k] += v
        print(f"pp 20a rank {rank}: the pipeline parts took {got['pp_s']:.1f} s, the sp 2 steps {got['sp_s']:.1f} s")
    print(f"pp 20a world: {PP_WORLD} processes took {time.perf_counter() - t0:.1f} s ({card})")


def _sp_steps_part(card: str, total: dict[str, int]) -> None:
    """20b: on a one-rank NCCL group, ``make_mesh(dp=1, sp=1)``: one DiT-512/8 ``training.train_step`` (batch
    4 of 4x64x64) with ``attention="ring"`` (B11 a hop, its gradient through the plain version) and
    ``"ulysses"`` (B9), its loss and the gradients it leaves against the flash DiT's loss and gradients (K2
    with its LSE, K5), within 5e-2 relative max (bf16).  Only the two steps' launches are counted: the
    flash DiT is their reference."""
    import torch
    import torch.distributed as dist

    from skrample_tpu_torch.models.dit import DiT
    from skrample_tpu_torch.models.ema import ema_init
    from skrample_tpu_torch.parallel import make_mesh
    from skrample_tpu_torch.training import make_optimizer, train_step

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(f"{tmp}/store", 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh(dp=1, sp=1)
            config, tree = _dit512()
            gen = torch.Generator(dev).manual_seed(21)
            x0, noise = (torch.randn((PP_BATCH, 4, PP_SIZE, PP_SIZE), generator=gen, device=dev) for _ in range(2))
            sigma = torch.rand((PP_BATCH,), generator=gen, device=dev) * 0.998 + 1e-3
            flash = DiT(config, device=dev).load_jax_params(tree)
            want = _flow_loss(flash, x0, noise, sigma)
            want.backward()
            want_loss, want_grads = float(want.detach()), {n: p.grad.float() for n, p in flash.named_parameters()}
            del flash, want
            for attention, kernel in (("ring", "flash_attention_block_stats"), ("ulysses", "flash_attention_forward")):
                model = DiT(dataclasses.replace(config, attention=attention), mesh=mesh, device=dev)
                model.load_jax_params(tree)
                opt, ema = make_optimizer(model), ema_init(model)
                _reset_counters()
                t0 = time.perf_counter()
                loss = float(train_step(model, opt, ema, x0, noise, sigma, 0, mesh=mesh))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = _counters()
                grads = {n: p.grad.float() for n, p in model.named_parameters()}  # the step leaves its gradients
                rel, err = abs(loss - want_loss) / abs(want_loss), _grad_err(grads, want_grads)
                finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
                print(f"sp 20b: DiT-512/8 train_step attention={attention!r} on the one-rank NCCL mesh: loss "
                      f"{loss:.6f} against flash {want_loss:.6f} (relative {rel:.3e}), gradients within {err:.3e} "
                      f"relative max (tolerance 5e-2), the first call {ms:.1f} ms, launches {_nonzero(counts)} ({card})")
                expect(finite and rel <= 5e-2 and err <= 5e-2, f"sp 20b: the {attention} step differs ({rel}, {err})")
                expect(counts[kernel] > 0 and counts["adaln_backward"] > 0, f"sp 20b: the {attention} step launched {counts}")
                for name, v in counts.items():
                    total[name] += v
                del model, opt, ema, grads
        finally:
            dist.destroy_process_group()


def _experts_trace_part(card: str, total: dict[str, int]) -> None:
    """20c: the MoE FFN at ``scripts/bench_moe.py``'s widths (float32) on the card, dense routing against the
    capacity dispatch at full capacity by both methods (rtol 1e-4 relative max: sums in another order), each
    timed; then ``utils.trace`` around one DiT-512/8 request, its TensorBoard trace file read back for the
    card's kernels."""
    import torch

    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.dit import DiT
    from skrample_tpu_torch.ops import CompiledDenoiser, compile_sampler
    from skrample_tpu_torch.parallel import experts
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.utils import trace

    dev, sync, w = torch.device("cuda", 0), torch.cuda.synchronize, MOE_WIDTHS
    params = experts.init_moe_ffn(torch.Generator().manual_seed(0), w["dim"], w["hidden"], w["experts"], device=dev)
    tokens = torch.randn((1, w["tokens"], w["dim"]), generator=torch.Generator(dev).manual_seed(22), device=dev)
    with torch.inference_mode():
        dense = experts.moe_ffn(params, tokens)
        dense_ms = _median_step_ms(lambda _i: experts.moe_ffn(params, tokens), 5)[0]
        for method in ("gather", "onehot"):
            def run(_i=0, method=method):
                return experts.moe_ffn_capacity(params, tokens, capacity=w["tokens"], method=method)

            err = _relative(run(), dense)
            ms = _median_step_ms(run, 5)[0]
            print(f"moe 20c: {w['experts']} experts of dim {w['dim']}, hidden {w['hidden']}, {w['tokens']} tokens (f32): "
                  f"capacity dispatch {method!r} at full capacity against dense routing: relative max err {err:.3e} "
                  f"(tolerance 1e-4); median {ms:.3f} ms against dense {dense_ms:.3f} ms ({card})")
            expect(bool(torch.isfinite(dense).all()) and err <= 1e-4, f"moe 20c: {method} differs from dense by {err}")
    config, tree = _dit512()
    model = DiT(config, device=dev).load_jax_params(tree).requires_grad_(False)
    compiled = compile_sampler(structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(),
                               TRACE_REQUEST_STEPS)
    denoiser = CompiledDenoiser.build(compiled, device=dev)
    x = torch.randn((1, 4, PP_SIZE, PP_SIZE), generator=torch.Generator(dev).manual_seed(23), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.inference_mode():
            denoiser.run(model.as_sampleable(), x)  # warm
            sync()
            _reset_counters()
            t0 = time.perf_counter()
            with trace(f"{tmp}/tb"):
                out = denoiser.run(model.as_sampleable(), x)
                sync()
            seconds = time.perf_counter() - t0
        counts = _counters()
        files = list(Path(tmp, "tb").glob("*.pt.trace.json"))
        expect(len(files) == 1, f"trace 20c: {len(files)} trace files written")
        events = json.loads(files[0].read_text())["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"trace 20c: utils.trace around one {TRACE_REQUEST_STEPS}-step DiT-512/8 request: one TensorBoard trace "
              f"file of {files[0].stat().st_size / 2**20:.2f} MiB, {len(events)} events of which {kernels} card kernels, "
              f"{seconds:.2f} s with the profiler; launches {_nonzero(counts)} ({card})")
        expect(kernels > 0 and bool(torch.isfinite(out).all()), f"trace 20c: {kernels} kernel events in the trace")
    for name, v in counts.items():
        total[name] += v


def pp_phase(card: str) -> dict[str, int]:
    """Phase 20: the pipeline stages, the gradient through the ring and ulysses, the experts and the utilities.
    (a, and b's gloo half) Two gloo processes on the card: :func:`_pp_world_part`.  (b) A one-rank NCCL group:
    :func:`_sp_steps_part`.  (c) :func:`_experts_trace_part`."""
    phase_t0 = time.perf_counter()
    total: dict[str, int] = dict.fromkeys(_wrappers(), 0)
    _pp_world_part(card, total)
    t0 = time.perf_counter()
    _sp_steps_part(card, total)
    print(f"sp 20b: the one-rank steps took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _experts_trace_part(card, total)
    print(f"moe 20c: took {time.perf_counter() - t0:.1f} s")
    print(f"pp: phase took {time.perf_counter() - phase_t0:.1f} s")
    return total


def main() -> int:
    import gc

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
        pipelines = pipeline_phase(device["card"], sdxl_parts)
        wrappers = diffusers_phase(device["card"], sdxl_parts)
        graphed = graphs_phase(device["card"], dit_outputs, sdxl_parts)
        extras = extras_phase(device["card"])
        graphed_dit = sdxl_parts.pop("graphed_dit", None)
        stacks = controlnet_flux_phase(device["card"], sdxl_parts)  # before phase 16, which frees phase 7's UNet
        del dit_outputs
        sd3 = sd3_phase(device["card"], sdxl_parts, graphed_dit)
        sdxl_parts.clear()  # every earlier phase's models freed before phase 18
        del graphed_dit
        gc.collect()
        torch.cuda.empty_cache()
        t2i = t2i_parallel_phase(device["card"])
        gc.collect()
        torch.cuda.empty_cache()
        tp = tp_fsdp_phase(device["card"])
        gc.collect()
        torch.cuda.empty_cache()
        pp = pp_phase(device["card"])
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1

    # each row's launches: its counts summed over every path's main-path run
    runs = (
        serving, train, dit_int8, flux_bf16, flux_int8, sdxl, vae, dit384, packed, video, sp, pipelines, wrappers, graphed,
        extras, sd3, stacks, t2i, tp, pp,
    )
    for name, row in rows.items():
        row["launches"] = sum(run.get(name, 0) for run in runs)
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
