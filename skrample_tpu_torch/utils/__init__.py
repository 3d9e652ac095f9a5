"""Small shared utilities: guidance combinators for model closures, image quality metrics,
profiling and the kernels' build cache."""

from .guidance import classifier_free, interval_classifier_free, rescaled_classifier_free
from .observability import enable_compilation_cache, trace
from .quality import psnr, ssim

__all__ = [
    "classifier_free",
    "enable_compilation_cache",
    "interval_classifier_free",
    "psnr",
    "rescaled_classifier_free",
    "ssim",
    "trace",
]
