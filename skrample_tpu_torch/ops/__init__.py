"""The device engine.

* :mod:`.compiler` — runs a structured sampler *symbolically* (linear
  combination tracing) to extract per-step scalar coefficient tables.
* :mod:`.fused` — applies one step's table as a single fused elementwise
  FMA (the plain chain on CPU, kernel K1 on CUDA), with weights by value or
  per item from a table on the device (K1's device-weights mode).
* :mod:`.loop` — the denoise loops: the step loop over a table-compiled
  sampler (``run(graph=True)``: one CUDA graph), the single-step APIs
  ``jitted_step``/``jitted_step_indexed`` (K1 on the resident table), the RK
  tableau loop, the generic fallback and the adaptive loop with its
  controller on the host.
* :mod:`.graphs` — CUDA-graph capture over static buffers with the launch
  counters replayed (the port's ``jax.jit``).
* :mod:`.adaptive` — adaptive RK (RKMoire) over precomputed (cursor, size)
  coefficient tables.
* :mod:`.adaln` — fused layernorm + adaLN modulation (kernel K3) and its
  backward (K6).
* :mod:`.flash_attention` — attention off the fused qkv projection (K2),
  with the logsumexp forward (K4) and the backward (K5) for training,
  d=64 attention on packed, strided q/k/v (B10), attention on
  (B, H, N, d) and on packed d=128 heads (B9), and one K/V block's
  attention with its row statistics, a ring hop (B11).
* :mod:`.groupnorm` — channels-last GroupNorm (+ f32 affine) (+ SiLU)
  (kernel B8).
* :mod:`.fused_conv` — a 3x3 conv with GroupNorm(+affine)+SiLU applied to
  its input as it is read, a residual epilogue and the output's channel
  statistics (kernel B12), the causal temporal conv of the same kind
  (kernel B13); the statistics chain of the fused VAE decodes.
* :mod:`.rope` — per-head RMS qk-norm + rotary embedding on the fused qkv
  projection (kernel B7).
* :mod:`.quant` — the int8 serving path: per-row activation quantization
  (kernel B6), per-channel weights, the int8 product.

Every kernel is written by hand in ``csrc/`` and built on first use
(:mod:`._cuda`); nothing here imports a compiler or touches a card at
import time.
"""

from .adaptive import rkmoire_device_loop
from .compiler import CompiledSampler, NonlinearSamplerError, compile_sampler
from .flash_attention import (
    flash_attention_forward,
    flash_attention_packed,
    flash_attention_packed_forward,
    flash_attention_pairs,
    flash_attention_pairs_forward,
)
from .fused import fused_step, fused_step_cuda, fused_step_indexed, fused_step_indexed_cuda
from .graphs import CapturedGraph, LaunchTally
from .fused_conv import (
    channel_stats,
    conv3x3_gn_silu,
    conv3x3_gn_silu_forward,
    conv3x3_ref,
    finalize_group_stats,
    tconv_causal_gn_silu,
    tconv_causal_gn_silu_forward,
    tconv_causal_ref,
)
from .groupnorm import groupnorm_cl, groupnorm_eager_bign, groupnorm_forward, groupnorm_reference
from .loop import CompiledDenoiser, generic_sample_loop, rk_sample_loop, rkmoire_sample_loop, sample_loop
from .quant import dense_int8, quantize_activation, quantize_params, quantize_rows, quantize_weight
from .rope import fused_rope_qk_norm, rope_qk_norm_forward, rope_qk_norm_reference

__all__ = [
    "CapturedGraph",
    "CompiledDenoiser",
    "CompiledSampler",
    "LaunchTally",
    "NonlinearSamplerError",
    "channel_stats",
    "compile_sampler",
    "conv3x3_gn_silu",
    "conv3x3_gn_silu_forward",
    "conv3x3_ref",
    "dense_int8",
    "finalize_group_stats",
    "flash_attention_forward",
    "flash_attention_packed",
    "flash_attention_packed_forward",
    "flash_attention_pairs",
    "flash_attention_pairs_forward",
    "fused_rope_qk_norm",
    "fused_step",
    "fused_step_cuda",
    "fused_step_indexed",
    "fused_step_indexed_cuda",
    "generic_sample_loop",
    "groupnorm_cl",
    "groupnorm_eager_bign",
    "groupnorm_forward",
    "groupnorm_reference",
    "quantize_activation",
    "quantize_params",
    "quantize_rows",
    "quantize_weight",
    "rk_sample_loop",
    "rkmoire_device_loop",
    "rkmoire_sample_loop",
    "rope_qk_norm_forward",
    "rope_qk_norm_reference",
    "sample_loop",
    "tconv_causal_gn_silu",
    "tconv_causal_gn_silu_forward",
    "tconv_causal_ref",
]
