"""K6's and K1's launch plans, and K6's merge order, on the CPU.

The plans are plain Python (``adaln.backward_chunks``, ``fused.step_plan``,
``fused.step_instance``) that the wrappers hand to the kernels; here they are
held to their invariants, and K6's chunked, fixed-order sums over tokens are
emulated in numpy and held against the JAX package's Pallas backward in
interpret mode.  K6's token rows a block are the kernel's own
(``skt_adaln_backward_rows``); the card test
``test_torch_kernels.py::test_adaln_backward_rows`` holds them to
:func:`_kernel_rows`, the geometry emulated here.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu_torch import scheduling
from skrample_tpu_torch.ops import adaln, compile_sampler, fused
from skrample_tpu_torch.ops.loop import CompiledDenoiser
from skrample_tpu_torch.sampling import models, structured

jadaln = importlib.import_module("skrample_tpu.ops.adaln")

CSRC = Path(adaln.__file__).resolve().parent.parent / "csrc"
ADALN_CU = (CSRC / "adaln.cu").read_text()
FUSED_CU = (CSRC / "fused_step.cu").read_text()
SMS, SMEM_BYTES = 132, 232448  # the H100's SMs and a block's shared memory


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+);", source).group(1))


def _widths() -> list[int]:
    "The row widths K3 and K6 are instantiated for, read from ``skt_adaln_supports``."
    body = ADALN_CU[ADALN_CU.index('extern "C" int skt_adaln_supports') :]
    body = body[: body.index("return 1;")]
    return [128 * int(c) for c in re.findall(r"case (\d+):", body)]


# ---- K6: the plan -------------------------------------------------------------


ROWS_PER_WARP = 4


def _kernel_rows(d: int) -> int:
    """K6's token rows a block at width ``d`` (``bwd_rows`` in csrc/adaln.cu): 8 warps of 4 rows
    where a lane keeps its columns' sums in registers (``d`` up to 1024), 4 warps above."""
    return (8 if d <= 1024 else 4) * ROWS_PER_WARP


def test_widths_are_the_kernel_instances() -> None:
    "The widths these tests run over are the list of ``skt_adaln_supports``."
    assert _widths() == [128 * c for c in (1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 16, 18, 19, 24)]


@pytest.mark.parametrize("d", _widths())
@pytest.mark.parametrize("n", [1, 17, 250, 1000, 1024])
def test_backward_plan(n: int, d: int) -> None:
    """Chunks cover the tokens once (only the last may be short, none is empty), and the warps'
    shared-memory sums fit a block; the count never sees the batch."""
    rows = _kernel_rows(d)
    chunks = adaln.backward_chunks(n, rows)
    assert chunks >= 1 and (chunks - 1) * rows < n <= chunks * rows
    assert rows // ROWS_PER_WARP * 2 * d * 4 <= SMEM_BYTES
    if (n, d) == (1024, 512):  # the DiT training slice: 128 blocks at batch 4, one wave
        assert 4 * chunks == 128 <= SMS


def _emulate_backward(x: np.ndarray, g: np.ndarray, scale: np.ndarray) -> tuple[np.ndarray, ...]:
    """K6 in numpy float32: each row's dx as the kernel computes it, and the sums over tokens in its
    order: a warp's rows (n0, n0 + warps, ...) one after another, the warps of a chunk in warp order,
    runs of ceil(chunks / kReduceRuns) consecutive chunks in chunk order, the runs in order."""
    B, N, D = x.shape
    rows = _kernel_rows(D)
    warps, chunks = rows // ROWS_PER_WARP, adaln.backward_chunks(N, rows)
    f32 = np.float32
    centered = x - x.mean(-1, keepdims=True, dtype=f32)
    inv_std = f32(1) / np.sqrt((centered * centered).mean(-1, keepdims=True, dtype=f32) + f32(1e-6))
    xhat = centered * inv_std
    dxhat = g * (f32(1) + scale[:, None])
    m1 = dxhat.mean(-1, keepdims=True, dtype=f32)
    m2 = (dxhat * xhat).mean(-1, keepdims=True, dtype=f32)
    dx = (dxhat - m1 - xhat * m2) * inv_std
    runs = _constant(ADALN_CU, "kReduceRuns")
    length = -(-chunks // runs)
    sums = np.zeros((2, B, D), f32)
    for b in range(B):
        blocks = []
        for c in range(chunks):
            for w in range(warps):
                acc = np.zeros((2, D), f32)
                for i in range(ROWS_PER_WARP):
                    n = c * rows + w + i * warps
                    if n >= N:
                        break
                    acc = acc + np.stack([g[b, n], g[b, n] * xhat[b, n]])
                block = acc if w == 0 else block + acc
            blocks.append(block)
        for r, first in enumerate(range(0, chunks, length)):
            run = blocks[first]
            for block in blocks[first + 1 : first + length]:
                run = run + block
            sums[:, b] = run if r == 0 else sums[:, b] + run
    return dx, sums[0], sums[1]


@pytest.mark.parametrize(("n", "d"), [(250, 256), (40, 1152), (768, 128)])
def test_backward_merge_order_matches_jax(n: int, d: int) -> None:
    """K6's chunked, fixed-order sums (emulated) vs the JAX Pallas backward in interpret mode at a
    ragged N (a short last chunk), with register sums (D 128, 256) and shared-memory sums (D 1152),
    and at 24 chunks an item (8 runs of 3):
    the tolerances of ``test_torch_training.py::test_adaln_backward_matches_jax`` (f32: atol 1e-4
    on dx, 1e-5 * N on the sums)."""
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((2, n, d), dtype=np.float32) * np.float32(2) + np.float32(0.1)
    g = rng.standard_normal((2, n, d), dtype=np.float32)
    scale = rng.standard_normal((2, d), dtype=np.float32)
    want = jadaln.adaln_backward(jnp.asarray(x), jnp.asarray(g), jnp.asarray(scale), interpret=True)
    got = _emulate_backward(x, g, scale)
    for name, mine, ref, tol in zip(("dx", "dshift", "dscale"), got, want, (1e-4, 1e-5 * n, 1e-5 * n)):
        np.testing.assert_allclose(mine, np.asarray(ref), rtol=0, atol=tol, err_msg=name)


# ---- K1: the instances and the plan ---------------------------------------------


def test_step_args_match_the_kernel_source() -> None:
    "``_FusedStepArgs`` is ``FusedStepArgs`` field for field; the limits are the kernel's."
    body = FUSED_CU[FUSED_CU.index("struct FusedStepArgs {") :]
    body = body[: body.index("};")]
    names = re.findall(r"(\w+)(?:\[\w+\])*;", body)
    assert names == [name for name, _ in fused._FusedStepArgs._fields_]
    assert _constant(FUSED_CU, "kMaxK") == fused._MAX_K
    assert _constant(FUSED_CU, "kUnrolledK") == fused._UNROLLED_K
    assert _constant(FUSED_CU, "kMaxRows") == fused._MAX_ROWS
    assert _constant(FUSED_CU, "kMaxThreads") == max(fused._BLOCK_THREADS)
    assert ctypes.sizeof(fused._FusedStepArgs) % 8 == 0


def _samplers() -> list:
    out = [structured.Euler(), structured.Euler(stochasticity=1.0), structured.SPC()]
    out += [structured.DPM(order=o, stochasticity=s) for o in (1, 2, 3) for s in (0.0, 0.5)]
    out += [structured.Adams(order=o) for o in range(1, 10)]
    for cls in (structured.UniP, structured.UniPC):
        out += [cls(order=o, stochasticity=s) for o in range(1, 10) for s in (0.0, 0.5)]
    return out


def test_step_instances_cover_the_samplers() -> None:
    """Every (rows, K) the step loop hands K1 for the structured samplers, orders 1-9 with and
    without noise, has an instance: rows 1 or 3, K up to 30 (UniPC order 9 with noise).  Adams 9
    and UniPC 8-9 (5-9 with noise) need more than 16 basis tensors: the shared K-32 instance."""
    seen = set()
    for sampler in _samplers():
        compiled = compile_sampler(sampler, scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), 10)
        denoiser = CompiledDenoiser.build(compiled, device="cpu")
        rows, K = denoiser.rows, denoiser.host_weights.shape[-1]
        seen.add((rows, K))
        assert fused.step_instance(rows, K) == (rows, K if K <= 16 else 32)
    assert {rows for rows, _ in seen} == {1, 3}
    assert max(K for _, K in seen) == 30 and any(K > 16 for _, K in seen)
    assert fused.step_instance(3, 30) == (3, 32) and fused.step_instance(1, 16) == (1, 16)
    assert fused.step_instance(2, 4) == (2, 32)  # rows 2: no sampler emits it, the run-time-K instance
    for rows, K in ((4, 2), (1, 33), (1, 0)):
        with pytest.raises(ValueError, match="rows <= 3, K <= 32"):
            fused.step_instance(rows, K)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1, 8, 1155, 65536, 262144, 16 * 4 * 64 * 64, 10**8])
def test_step_plan(n: int, dtype: torch.dtype, aligned: bool) -> None:
    """Threads cover every vector and the scalar tail once a grid-stride pass, up to one wave of the
    card; blocks of 32-128 threads, every SM a block wherever there is a block's work for each;
    the paths' smallest latents (65536 elements) spread over at least 128 SMs."""
    vec, threads, blocks = fused.step_plan(n, dtype, aligned)
    assert vec == ((16 // torch.empty((), dtype=dtype).element_size()) if aligned else 1)
    work = max(n // vec, n % vec)
    assert threads in (32, 64, 128)
    assert 1 <= blocks * threads <= 2048 * SMS
    assert blocks * threads >= work or blocks * threads == 2048 * SMS
    if work >= 32 * SMS:
        assert blocks >= SMS
    if work > 128 * SMS:
        assert threads == 128
    if n == 65536 and aligned:
        assert blocks >= 128


# ---- the card's busy time in a trace (chip_smoke.card_time) -----------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_card_time_counts_overlapping_spans_once() -> None:
    """A programmatic dependent traced from its launch, under the kernel before it: the union of the
    spans is the busy time, the overlap counts for the kernel that started first; a user annotation
    and a host event count for nothing."""
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(key, start, end, device=cuda, annotation=False):
        return SimpleNamespace(
            key=key, device_type=device, is_user_annotation=annotation, time_range=SimpleNamespace(start=start, end=end)
        )

    events = [
        event("reduce", 12.0, 30.0),  # launched at 12 under "main", runs past it to 30
        event("main", 10.0, 25.0),
        event("step", 40.0, 45.0),
        event("step", 50.0, 52.0),
        event("Optimizer.step", 0.0, 60.0, annotation=True),
        event("cudaLaunchKernel", 9.0, 11.0, device=cpu),
    ]
    ms, launches, busy = _chip_smoke().card_time(SimpleNamespace(events=lambda: events))
    assert ms == {"main": 0.015, "reduce": 0.005, "step": 0.007}
    assert launches == {"main": 1, "reduce": 1, "step": 2}
    assert busy == pytest.approx(0.027)
