"""The device engine.

* :mod:`.compiler` — runs a structured sampler *symbolically* (linear
  combination tracing) to extract per-step scalar coefficient tables.
* :mod:`.fused` — applies one step's table as a single fused elementwise
  FMA (the plain chain on CPU, kernel K1 on CUDA).
* :mod:`.loop` — the denoise step loop over a table-compiled sampler.
* :mod:`.adaln` — fused layernorm + adaLN modulation (kernel K3) and its
  backward (K6).
* :mod:`.flash_attention` — attention off the fused qkv projection (K2),
  with the logsumexp forward (K4) and the backward (K5) for training.

Every kernel is written by hand in ``csrc/`` and built on first use
(:mod:`._cuda`); nothing here imports a compiler or touches a card at
import time.
"""

from .compiler import CompiledSampler, NonlinearSamplerError, compile_sampler
from .fused import fused_step, fused_step_cuda
from .loop import CompiledDenoiser

__all__ = [
    "CompiledDenoiser",
    "CompiledSampler",
    "NonlinearSamplerError",
    "compile_sampler",
    "fused_step",
    "fused_step_cuda",
]
