"""Profiling and the kernels' build cache.

The JAX package's ``utils/observability.py``: :func:`trace` profiles a
region into a TensorBoard trace (``torch.profiler`` here, with the card's
kernels where one is present), and :func:`enable_compilation_cache`
persists what is compiled across processes.  The port compiles no XLA
programs; what it compiles is its CUDA library (``ops/_cuda.py``: every
``csrc/`` source built by ``nvcc`` into a file named by a digest of the
sources and flags), so the cache is that library's directory.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from collections.abc import Iterator
from pathlib import Path

import torch

from ..ops._cuda import build_dir

BUILD_ENV = "SKRAMPLE_TPU_TORCH_BUILD"


def enable_compilation_cache(path: str | Path | None = None) -> Path:
    """Keep the compiled kernel library in ``path`` (default: the current build directory), so every
    later build of the same sources in this process or another loads it instead of running ``nvcc``
    (the library's name carries a digest of the sources and flags).  Sets ``$SKRAMPLE_TPU_TORCH_BUILD``
    and creates the directory; returns it.  A library this process has loaded already stays loaded."""
    target = Path(path).expanduser() if path is not None else build_dir()
    target.mkdir(parents=True, exist_ok=True)
    os.environ[BUILD_ENV] = str(target)
    return target


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None) -> Iterator[torch.profiler.profile]:
    """Profile a region into a TensorBoard trace (``<worker>.<time>.pt.trace.json`` in ``log_dir``,
    default ``skrample_tpu_torch_trace`` under the temporary directory), host ops and, on a machine
    with a card, its kernels; yields the profiler::

        with trace("tb"):
            engine.generate(seed)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = Path(log_dir) if log_dir is not None else Path(tempfile.gettempdir()) / "skrample_tpu_torch_trace"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
