"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: a reduced llama3.2-1b for 4 steps with checkpoints every 2, a
resume from step 4 that continues exactly as an uninterrupted run does,
and a run on HAIL-selected data (``--hail-select domain:3:3``)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import checkpoint as ck  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
        "--batch", "2", "--seq", "16"]


def test_launcher_runs_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
         "--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step     4 loss=" in out.stdout and "done" in out.stdout
    assert ck.list_steps(d) == [2, 4]

    resumed = train.main([*ARGS, "--steps", "6", "--ckpt-dir", d,
                          "--ckpt-every", "2"])
    assert resumed["start"] == 4 and sorted(resumed["losses"]) == [5, 6]
    assert ck.list_steps(d) == [2, 4, 6]


def test_resume_continues_as_the_uninterrupted_run(tmp_path):
    """Steps 3-4 resumed from the step-2 checkpoint (same schedule) give
    the uninterrupted run's losses and final state."""
    d = str(tmp_path / "ckpt")
    whole = train.main([*ARGS, "--steps", "4", "--ckpt-dir", d,
                        "--ckpt-every", "2"])
    import shutil
    shutil.rmtree(os.path.join(d, "step_00000004"))
    resumed = train.main([*ARGS, "--steps", "4", "--ckpt-dir", d])
    assert resumed["start"] == 2 and sorted(resumed["losses"]) == [3, 4]
    for s in (3, 4):
        assert resumed["losses"][s] == whole["losses"][s]
    for a, b in zip(ck._flatten(resumed["state"]).values(),
                    ck._flatten(whole["state"]).values()):
        assert torch.equal(a, b)


def test_launcher_trains_on_hail_selected_data():
    out = train.main([*ARGS, "--steps", "3", "--hail-select", "domain:3:3"])
    assert sorted(out["losses"]) == [1, 2, 3]
    assert all(torch.isfinite(torch.tensor(list(out["losses"].values()))))


def test_launcher_wants_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1"])
