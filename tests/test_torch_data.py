"""The port's input pipeline against the JAX package's ``data.py``: bit for bit.

``EpochLoader`` draws its epochs with ``prng.permutation`` (jax's
``_shuffle``: rounds of stable sorts by threefry bits), so the port's batches
equal the JAX loader's exactly, over epochs and from a resume cursor.
``prefetch_to_device`` is checked on the CPU (order, the bounded queue,
errors); its card path (pinned copies on a side stream) runs in
``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import itertools
import threading

import jax
import numpy as np
import pytest
import torch

from skrample_tpu import data as jdata
from skrample_tpu_torch import data, prng


@pytest.mark.parametrize("n", [1, 64, 1000, 70000])
def test_permutation_is_jax_bit_for_bit(n: int) -> None:
    "One sort round below 2**32**(1/3) items, two above (70000): the same order as ``jax.random.permutation``."
    for seed in (0, 7):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        want = np.asarray(jax.random.permutation(key, n))
        got = prng.permutation(prng.fold_in(prng.PRNGKey(seed), 3), n, device="cpu")
        assert np.array_equal(got.numpy(), want)


def test_epoch_loader_is_jax_bit_for_bit() -> None:
    """Batches over three epochs (20 examples in batches of 6: the remainder dropped), a nested
    dict of float and int arrays, and from a resume cursor: equal to the JAX loader's."""
    rng = np.random.default_rng(0)
    arrays = {"x0": rng.standard_normal((20, 3, 2), dtype=np.float32), "meta": {"label": np.arange(20, dtype=np.int32)}}
    want = jdata.EpochLoader(arrays, 6, jax.random.PRNGKey(7))
    got = data.EpochLoader(arrays, 6, prng.PRNGKey(7))
    assert got.per_epoch == want.per_epoch == 3
    for step in range(9):
        a, b = got.batch_at(step), want.batch_at(step)
        assert isinstance(a["x0"], torch.Tensor)
        assert np.array_equal(a["x0"].numpy(), np.asarray(b["x0"]))
        assert np.array_equal(a["meta"]["label"].numpy(), np.asarray(b["meta"]["label"]))
    resumed = list(itertools.islice(got.iter_from(4), 3))
    assert all(torch.equal(r["x0"], got.batch_at(4 + i)["x0"]) for i, r in enumerate(resumed))
    ragged = data.EpochLoader({"x": torch.arange(20)}, 6, prng.PRNGKey(7), drop_remainder=False)
    assert ragged.per_epoch == 4 and ragged.batch_at(3)["x"].shape == (2,)
    with pytest.raises(ValueError, match="leading"):
        data.EpochLoader({"a": np.zeros(3), "b": np.zeros(4)}, 2, prng.PRNGKey(0))
    with pytest.raises(ValueError, match="batch"):
        data.EpochLoader({"a": np.zeros(3)}, 4, prng.PRNGKey(0))


def test_prefetch_on_the_cpu_keeps_order_bounds_its_queue_and_raises() -> None:
    "Batches in order; the producer at most ``depth`` (+ the one in hand) ahead; a producer error raised at the consumer."
    drawn = []
    gate = threading.Event()

    def source():
        for i in range(10):
            drawn.append(i)
            yield {"i": torch.tensor(i)}

    it = data.prefetch_to_device(source(), depth=2, device="cpu")
    first = next(it)
    gate.wait(0.2)
    assert first["i"].item() == 0 and len(drawn) <= 4
    assert [b["i"].item() for b in it] == list(range(1, 10))

    def broken():
        yield {"i": torch.tensor(0)}
        raise RuntimeError("decode failed")

    it = data.prefetch_to_device(broken(), device="cpu")
    assert next(it)["i"].item() == 0
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    placed = data.prefetch_to_device(iter([{"i": torch.tensor(1)}]), place=lambda b: {"i": b["i"] + 1})
    assert [b["i"].item() for b in placed] == [2]
