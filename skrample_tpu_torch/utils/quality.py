"""Image quality metrics (numpy, dependency-free): the JAX package's
``utils/quality.py``, copied (the port imports nothing of that package).

Used by the tableau quality search (:mod:`.tableau_search`); SSIM follows
Wang et al. 2004 with the standard 7x7 gaussian window (sigma 1.5) and
K1/K2 = 0.01/0.03.  Torch tensors are read through ``np.asarray`` (host
tensors; move a card's to the host first).
"""

from __future__ import annotations

import numpy as np


def _gaussian_window(size: int = 7, sigma: float = 1.5) -> np.ndarray:
    offsets = np.arange(size, dtype=np.float64) - (size - 1) / 2
    kernel = np.exp(-(offsets**2) / (2 * sigma**2))
    kernel /= kernel.sum()
    return np.outer(kernel, kernel)


def _filter2d(image: np.ndarray, window: np.ndarray) -> np.ndarray:
    "Valid-mode 2D correlation via stride tricks (image: (H, W))."
    k = window.shape[0]
    h, w = image.shape
    shape = (h - k + 1, w - k + 1, k, k)
    strides = (*image.strides, *image.strides)
    patches = np.lib.stride_tricks.as_strided(image, shape, strides)
    return np.einsum("hwij,ij->hw", patches, window)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float | None = None) -> float:
    """Mean structural similarity between two images.

    Accepts (H, W) or any leading dims (channels/batch are averaged)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim > 2:
        flat_a = a.reshape(-1, *a.shape[-2:])
        flat_b = b.reshape(-1, *b.shape[-2:])
        return float(np.mean([ssim(x, y, data_range) for x, y in zip(flat_a, flat_b, strict=True)]))

    if data_range is None:
        lo = min(a.min(), b.min())
        hi = max(a.max(), b.max())
        data_range = float(hi - lo) or 1.0

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_window()

    mu_a = _filter2d(a, win)
    mu_b = _filter2d(b, win)
    var_a = _filter2d(a * a, win) - mu_a**2
    var_b = _filter2d(b * b, win) - mu_b**2
    cov = _filter2d(a * b, win) - mu_a * mu_b

    score = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(score.mean())


def psnr(a: np.ndarray, b: np.ndarray, data_range: float | None = None) -> float:
    "Peak signal-to-noise ratio in dB."
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if data_range is None:
        data_range = float(max(a.max(), b.max()) - min(a.min(), b.min())) or 1.0
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range**2 / mse))
