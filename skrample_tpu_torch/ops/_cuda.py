"""Build and load the port's hand-written CUDA kernels.

Every kernel lives in ``skrample_tpu_torch/csrc/*.cu`` behind a plain C
entry point.  On first use the sources are compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together, then linked into ONE shared library that is loaded with
:mod:`ctypes`.  Nothing here runs when a module is imported: the CPU test
tier imports every module on a machine without ``nvcc``.

The library lands in ``build/skrample_tpu_torch/`` beside the package (or in
``$SKRAMPLE_TPU_TORCH_BUILD``) under a name that hashes the sources and the
flags, so an edited source never loads a stale binary.  The build writes to
a temporary name and ``os.replace``\\ s it into place under an exclusive file
lock: concurrent processes (pytest workers, a server and its tests) can
never load a half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (
    "fused_step.cu",
    "flash_attention_sm90.cu",
    "flash_attention_bwd.cu",
    "adaln.cu",
    "quant.cu",
    "rope.cu",
    "groupnorm.cu",
    "fused_conv.cu",
    "tconv.cu",
)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures of the entry points (see the sources for what each computes)
_SIGNATURES: dict[str, list] = {
    "skt_fused_step": [_P, _I, _I, _P],  # args struct, its size, dtype code, stream
    # qkv, out, B, N, H, d, dtype, scale, block_q, stages (flash_attention.attention_plan), stream
    "skt_flash_attention_qkv": [_P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "skt_flash_attention_qkv_lse": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],  # qkv, out, lse, then as above
    "skt_attention_sm90_probe": [_P, _P, _P, _I, _I, _I, _P],  # a, b, out, mode, d, dtype, stream
    # qkv, dout, lse, delta, dqkv, B, N, H, d, dtype, scale, then block, dq_stages, query_tile, dkv_stages
    # (flash_attention.attention_backward_plan), stream
    "skt_flash_attention_qkv_backward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    # x, shift, scale, out, B, N, D, shift row stride, scale row stride, dtype, eps, stream
    "skt_adaln": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _F, _P],
    "skt_adaln_supports": [_I],  # D -> 1 when the kernel is instantiated for that width
    # x, g, scale, dx, partials, dshift, dscale, B, N, D, chunks (adaln.backward_chunks), scale row stride, dtype,
    # eps, stream
    "skt_adaln_backward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _F, _P],
    "skt_adaln_backward_rows": [_I],  # D -> token rows a block of the backward (sizes its partials)
    "skt_quant_rows": [_P, _P, _P, _L, _I, _I, _P],  # x, q, s, R, D, dtype, stream
    # qkv in, out (the same pointer: in place), cos, sin, table row stride, q gain, k gain, B, N, H, d, dtype, eps, stream
    "skt_rope_qk_norm": [_P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, y, scale, bias (both None: no affine), f32 scratch, arrival counters, B, N, C, groups, vec, rows per
    # chunk, chunks, row lanes (groupnorm.launch_geometry), dtype, silu, eps, stream
    "skt_groupnorm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "skt_flash_attention_strided": [_P, _I, _I, _P],  # args struct, its size, dtype code, stream
    "skt_flash_attention_block_stats": [_P, _I, _I, _P],  # args struct, its size, dtype code, stream
    # x, w (Co, 3, 3, C), bias, stats, gn scale, gn bias, residual, out, partial, raw, the f32 route's split
    # weights (null where unused), N, H, W, C, Co, dtype, plan (fused_conv.conv3x3_plan), stream
    "skt_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _IP, _P],
    "skt_conv_tf32_probe": [_P, _P, _P, _I, _I, _P],  # a, b, out, n, mode, stream
    # x, wt (Co, k, C), bias, stats, residual, out, partial, raw (null where unused), B, T_in, S, C, Co, k, rep,
    # dtype, plan (fused_conv.tconv_plan), stream
    "skt_tconv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _IP, _P],
    "skt_error_string": [_I],
}


def build_dir() -> Path:
    "Where the compiled library lives (``build/skrample_tpu_torch`` beside the package)."
    env = os.environ.get("SKRAMPLE_TPU_TORCH_BUILD")
    return Path(env) if env else CSRC.parent.parent / "build" / "skrample_tpu_torch"


def _nvcc() -> str:
    for candidate in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and Path(candidate).is_file():
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built from csrc/ on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    "Compile every source in parallel, link one library, move it into place atomically."
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src} ==\n{out}")
            if proc.returncode:
                failed.append(src)
        text = "\n".join(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{text}")
        staged = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(staged), *(str(obj) for _, obj, _ in procs)],
            capture_output=True,
            text=True,
        )
        if link.returncode:
            raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}{link.stderr}")
        target.with_suffix(".log").write_text(text)
        os.replace(staged, target)


def library() -> ctypes.CDLL:
    "The loaded kernel library, built on first call."
    global _lib, _log
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        target = out_dir / f"libskrample_tpu_torch-{_digest()}.so"
        with open(out_dir / ".lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if not target.exists():
                    _compile(target)
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
        log_path = target.with_suffix(".log")
        _log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "skt_error_string" else ctypes.c_int
        _lib = lib
        return lib


def build_log() -> str:
    "The compiler's ``-Xptxas -v`` report from the build that produced the loaded library."
    library()
    return _log


def check(code: int, what: str) -> None:
    "Raise if a C entry point returned a CUDA error (``cudaGetLastError`` after the launch)."
    if code:
        message = library().skt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({message})")


def stream() -> int:
    "PyTorch's current stream on the current device, as the raw handle the C entry points take."
    return torch.cuda.current_stream().cuda_stream


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; asking for CUDA without a card raises.

    Entry points default to ``"cuda"`` and never carry on silently on the CPU:
    a caller who wants the CPU says ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available (pass device='cpu' to run on CPU)")
    return device


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3}
"Element type codes shared with the C entry points (float64: K1 only)."
