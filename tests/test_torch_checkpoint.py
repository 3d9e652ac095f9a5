"""The port's ``TrainCheckpointer`` and the training example's kill-and-resume recipe, on the CPU.

The JAX package's ``TrainCheckpointer`` writes orbax's format, which the port
does not read (the ``.npz`` parameter files are what crosses between the two
packages, ``tests/test_torch_training.py``); its contract is held here on its
own: save and restore, ``like=``, retention, an atomic commit (a torn
temporary directory is never listed and is removed), and the counterpart of
``tests/test_resume.py``: a run SIGKILLed mid-epoch by
``--abort-after-step`` and resumed equals an uninterrupted run bit for bit
(parameters, optimizer state, EMA), tolerance 0.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from skrample_tpu_torch import training
from skrample_tpu_torch.models.checkpoint import TrainCheckpointer

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--dim", "64", "--heads", "1", "--depth", "1", "--size", "8", "--batch", "4"]
RECIPE = ["--host-loader", "--until", "6", "--save-every", "2"]


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _same(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        (isinstance(x, torch.Tensor) and torch.equal(x, y) and x.dtype == y.dtype) or x == y for x, y in zip(la, lb)
    )


def test_save_restore_retention_and_torn_writes(tmp_path: Path) -> None:
    """A state of tensors, nested dicts, lists, numbers and None round-trips; the snapshot is taken
    before ``save`` returns; ``like=`` sets dtypes; 2 steps kept of 3; a torn temporary directory is
    never listed and the next checkpointer removes it."""
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "opt_state": {"state": {0: {"step": torch.tensor(3.0)}},
             "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999), "foreach": None, "params": [0]}]},
             "ema": {"w": torch.ones(2, 3, dtype=torch.bfloat16)}, "step": 3}
    with TrainCheckpointer(tmp_path, max_to_keep=2) as ckpt:
        ckpt.save(3, state)
        state["params"]["w"].add_(100)  # after save returns: not in the checkpoint
        ckpt.save(5, state)
        ckpt.save(7, state)
        ckpt.wait()
        assert ckpt.all_steps() == [5, 7] and ckpt.latest_step() == 7
        back = ckpt.restore(5)
        assert back["step"] == 3 and back["opt_state"]["param_groups"][0]["betas"] == (0.9, 0.999)
        assert torch.equal(back["params"]["w"], state["params"]["w"]) and back["ema"]["w"].dtype == torch.bfloat16
        like = ckpt.restore(like={"params": {"w": torch.zeros(2, 3, dtype=torch.float64)}})
        assert like["params"]["w"].dtype == torch.float64 and like["step"] == 3
    (tmp_path / ".tmp-9-123").mkdir()
    (tmp_path / ".tmp-9-123" / "state.pt").write_bytes(b"torn")
    assert TrainCheckpointer(tmp_path).latest_step() == 7
    assert not (tmp_path / ".tmp-9-123").exists()
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(tmp_path / "empty").restore()


def test_steps_of_every_layout_are_listed_and_never_replaced(tmp_path: Path) -> None:
    """ROADMAP C17: a committed step records its layout and is listed whatever layout wrote it; a save at the
    number of a step of another layout fails and leaves that step as it was, and keeping ``max_to_keep``
    steps removes only steps of the saver's own layout.  A step directory of two rank files without a
    record (the format before layouts) reads as a world of 2: its own-file restore refuses in one rank,
    ``restore_ranks`` reads both files."""
    state = {"params": {"w": torch.arange(4.0)}, "step": 4}
    with TrainCheckpointer(tmp_path, max_to_keep=1, async_save=False) as ckpt:
        ckpt.save(4, state, layout={"dp": 2})
        with pytest.raises(FileExistsError, match="another layout"):
            ckpt.save(4, {**state, "step": 5}, layout={"dp": 1})
        assert ckpt.layout(4) == {"dp": 2, "world": 1} and ckpt.restore(4)["step"] == 4
        for step in (5, 6):
            ckpt.save(step, state, layout={"dp": 1})
        assert ckpt.all_steps() == [4, 6] and ckpt.latest_step() == 6
    old = tmp_path / "8"
    old.mkdir()
    for rank in range(2):
        torch.save({"params": {"w": torch.full((2,), float(rank))}, "step": 8}, old / f"state-{rank}.pt")
    ckpt = TrainCheckpointer(tmp_path)
    assert ckpt.latest_step() == 8 and ckpt.layout(8) == {"world": 2}
    with pytest.raises(ValueError, match="a world of 2 ranks"):
        ckpt.restore(8)
    assert [float(r["params"]["w"][0]) for r in ckpt.restore_ranks(8)] == [0.0, 1.0]


@pytest.mark.parametrize("extra", [[], ["--opt8", "--lora", "4"]], ids=["adamw", "opt8-lora"])
def test_sigkill_mid_epoch_resume_is_bit_exact(tmp_path: Path, capsys, extra: list[str]) -> None:
    """Uninterrupted to step 6 against: SIGKILLed after step 3 (a subprocess: the step-4 save
    likely torn), then ``--resume --until 6`` from the step-2 (or 4) save.  The final states are
    equal bit for bit: parameters, optimizer state (AdamW's, or AdamW8bit's codes and scales), EMA."""
    straight, killed = tmp_path / "straight", tmp_path / "killed"
    assert training.main([*TINY, *RECIPE, *extra, "--orbax", str(straight)]) == 0
    cmd = [sys.executable, "-m", "skrample_tpu_torch.training", *TINY, *RECIPE, *extra, "--orbax", str(killed)]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run([*cmd, "--abort-after-step", "3"], capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert run.returncode == -signal.SIGKILL, (run.returncode, run.stdout[-500:], run.stderr[-1000:])
    assert "aborting after step 3 (fault injection)" in run.stdout
    assert TrainCheckpointer(killed).latest_step() in (2, 4)
    capsys.readouterr()
    assert training.main([*TINY, *RECIPE, *extra, "--orbax", str(killed), "--resume"]) == 0
    restored_at = int(capsys.readouterr().out.split("at step")[1].split()[0])
    assert restored_at in (2, 4)
    a, b = TrainCheckpointer(straight).restore(6), TrainCheckpointer(killed).restore(6)
    assert a["step"] == b["step"] == 6
    for part in ("params", "opt_state", "ema"):
        assert _same(a[part], b[part]), part
