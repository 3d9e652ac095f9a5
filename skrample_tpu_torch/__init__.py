"""skrample-tpu-torch: the PyTorch/CUDA port of skrample-tpu.

The same layer map as the JAX package, module for module, importing
``torch`` and ``numpy`` and never ``jax``:

  common      — value types + polymorphic scalar math (a copy of the JAX
                package's host layer, kept bit-exact)
  scheduling  — float64 host-side schedule stack
  sampling    — predictor algebra, the structured solvers, and the
                functional Runge-Kutta solvers over the tableau catalog
  noise       — counter-based noise generators on ``prng``'s threefry
  ops         — the device engine: coefficient-table compiler, the fused
                step (K1, weights by value or from a device table), the
                step, RK and adaptive loops, CUDA-graph capture
                (``ops.graphs``), fused adaLN (K3,
                backward K6) and fused-qkv attention (K2; K4 and K5 for
                training), each kernel hand-written in ``csrc/``
  models      — the DiT as an ``nn.Module``, its EMA shadow, ``.npz``
                parameter checkpoints
  pipeline    — ``GenerationPipeline``: construct once, generate per seed
                (img2img, guidance from ``utils.guidance``, structured noise);
                ``AdaptivePipeline`` (RKMoire)
  diffusers   — the diffusers scheduler wrapper (``SkrampleWrapperScheduler``
                and the RK wrappers; config translation in
                ``diffusers_config``, torch-stream noise in ``torch_noise``,
                ``skrample.*`` import aliases in ``compat``)
  serving     — the dynamic-batching engine; ``server`` its HTTP front-end;
                ``continuous`` the iteration-level (slot pool) engine
  parallel    — sequence-parallel serving on ``torch.distributed``: meshes,
                ring attention (kernel B11 a hop), Ulysses, joint streams
  training    — flow-matching training of the DiT
                (``python -m skrample_tpu_torch.training``)

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from . import common, scheduling
from .common import DeltaPoint, MergeStrategy, Point, Step

__version__ = "0.1.0"

__all__ = [
    "DeltaPoint",
    "MergeStrategy",
    "Point",
    "Step",
    "common",
    "scheduling",
]
