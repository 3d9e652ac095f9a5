#!/usr/bin/env python3
"""ROADMAP C6's cheap card check: can cuBLASLt's bias epilogue stand in for ``_dense``'s two passes, and
whose is the bf16 copy that leads a DiT request's card time?

    python3 scripts/check_dense_epilogue.py        # from the repository root, on one CUDA device

Part 1, at the bf16 dense shapes of the served SDXL base UNet (``chip_smoke.py`` phase 7: CFG batch 2 at
1024x1024, 4096 and 1024 tokens a level, 77 context tokens) and of the DiT-512/8 (phase 3, bucket 1):
``torch.addmm(b, x, wᵀ)`` with the bias in bf16 and a bf16 result (cuBLASLt's bias epilogue: the bias added
to the f32 accumulator before its one rounding) against ``models/dit.py``'s ``_dense_forward`` (the f32
product plus the f32 bias through ``aten.addmm.dtype``, then a rounding copy to bf16).  For each shape: how
many outputs differ and by how many bf16 ulps, and each one's card time (CUDA-graph replay, L2-warm).

Part 2, one DiT-512/8 request's 25 forwards at bucket 1 (bf16, f32 master weights, ``chip_smoke.py`` phase
3's model) traced by ``torch.profiler`` with ``_dense``'s two casts inside named ranges: the card time of the
kernels under the per-call weight cast (``layer.weight.to(bf16)``) and under the output rounding
(``y.to(bf16)``), against every copy kernel of the request.  Prints one line a measurement and, last, a JSON
object with every number.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (label, M rows, K, N): SDXL base at 1024x1024 under CFG (batch 2), then the DiT-512/8 at bucket 1
SHAPES = (
    ("SDXL 640 attention proj", 2 * 4096, 640, 640),
    ("SDXL 640 GEGLU in", 2 * 4096, 640, 5120),
    ("SDXL 640 ff out", 2 * 4096, 2560, 640),
    ("SDXL 1280 attention proj", 2 * 1024, 1280, 1280),
    ("SDXL 1280 GEGLU in", 2 * 1024, 1280, 10240),
    ("SDXL 1280 context k/v", 2 * 77, 2048, 1280),
    ("DiT-512 qkv", 1024, 512, 1536),
    ("DiT-512 mlp_out", 1024, 2048, 512),
)


def _ulps(a, b) -> int:
    import torch

    ia = a.view(torch.int16).int()
    ib = b.view(torch.int16).int()
    ia = torch.where(ia < 0, -32768 - ia, ia)  # sign-magnitude to a monotone integer line
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return int((ia - ib).abs().max())


def epilogue(results: dict) -> None:
    import torch

    import chip_smoke
    from skrample_tpu_torch.models.dit import _dense_forward

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(6)
    for label, M, K, N in SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((N, K), generator=gen, device=dev) / K**0.5).to(torch.bfloat16)
        b = (torch.randn((N,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        two_pass = _dense_forward(x, w, b)
        fused = torch.addmm(b, x, w.t())
        torch.cuda.synchronize()
        differ = int((two_pass != fused).sum())
        ulps = _ulps(fused, two_pass)
        two_ms, _ = chip_smoke.cuda_ms(lambda: _dense_forward(x, w, b))
        epi_ms, _ = chip_smoke.cuda_ms(lambda: torch.addmm(b, x, w.t()))
        print(
            f"{label} ({M}x{K} @ {K}x{N}, bf16): addmm with the bf16 bias vs _dense_forward: {differ} of {M * N} "
            f"outputs differ, at most {ulps} bf16 ulp; card time {epi_ms * 1e3:.2f} us (epilogue) vs "
            f"{two_ms * 1e3:.2f} us (two passes)"
        )
        results[label] = {
            "differ": differ, "outputs": M * N, "max_ulp": ulps, "epilogue_us": epi_ms * 1e3, "two_pass_us": two_ms * 1e3
        }


def request_trace(results: dict) -> None:
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from skrample_tpu_torch.models import dit
    from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree

    dev = torch.device("cuda")
    config = DiTConfig(dim=512, depth=8, heads=4, patch=2, channels=4, compute_dtype=torch.bfloat16, attention="flash")
    model = DiT(config, device=dev).load_jax_params(random_param_tree(config, seed=0)).requires_grad_(False)

    def ranged_forward(x, w, b):
        "``_dense_forward`` with its rounding copy inside a named range."
        x2 = x.reshape(-1, x.shape[-1])
        y = torch.addmm(b.float(), x2, w.t(), out_dtype=torch.float32)
        with record_function("dense output rounding"):
            out = y.to(x.dtype)
        return out.view(*x.shape[:-1], y.shape[-1])

    def ranged_dense(layer, x, dtype):
        "``_dense`` with its weight cast inside a named range."
        with record_function("dense weight cast"):
            w = layer.weight.to(dtype)
        return ranged_forward(x, w, layer.bias)

    x = torch.randn((1, 4, 64, 64), generator=torch.Generator(dev).manual_seed(3), device=dev)
    t = torch.linspace(999.0, 1.0, 25, device=dev)
    with torch.inference_mode():
        want = model(x, t[0])
        with mock.patch.object(dit, "_dense", ranged_dense):
            same = torch.equal(model(x, t[0]), want)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
                for i in range(25):
                    model(x, t[i])
                torch.cuda.synchronize()
    print(f"DiT-512/8: the ranged _dense gives the model's output bit for bit: {same}")
    kernel_ms, _launches, busy = chip_smoke.card_time(prof)
    ranges = {}
    for name in ("dense weight cast", "dense output rounding"):
        ranges[name] = sum(
            e.device_time_total for e in prof.events()
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU
        ) / 1e3
    copies = {k: v for k, v in kernel_ms.items() if "copy" in k.lower()}
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:5]
    print(
        f"DiT-512/8 request (25 eager forwards, bucket 1): card busy {busy:.3f} ms; copy kernels "
        f"{sum(copies.values()):.3f} ms; under _dense's weight cast {ranges['dense weight cast']:.3f} ms, under its "
        f"output rounding {ranges['dense output rounding']:.3f} ms"
    )
    for name, ms in top:
        print(f"  {ms:8.3f} ms  {name[:150]}")
    results["request"] = {
        "busy_ms": busy,
        "copy_kernels_ms": sum(copies.values()),
        "weight_cast_ms": ranges["dense weight cast"],
        "output_rounding_ms": ranges["dense output rounding"],
        "top_kernels": [[name[:150], ms] for name, ms in top],
    }


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("check_dense_epilogue: no CUDA device", file=sys.stderr)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    results: dict = {"card": card}
    epilogue(results)
    request_trace(results)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
