"""The port's training launcher (``repro_torch.launch.train``) against the
JAX package's CLI (``repro.launch.train``), both called in-process: the
same closing lines (SVD accounting; under ``--adaptive-rank`` the rank
transitions and the optimizer state's size), the distributed flags refused
by name, a resume through ``--checkpoint-dir``, and no silent fallback to
the CPU."""
import re
import shutil
import sys

import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train

ARGS = ["--arch", "llama-60m", "--smoke", "--steps", "6", "--batch", "4",
        "--seq", "32", "--adaptive-rank"]


def _closing(out: str) -> dict:
    lines = out.strip().splitlines()
    final = next(l for l in lines if l.startswith("final loss"))
    m = re.fullmatch(r"final loss (\S+); SVD used (\d+) / (\d+) baseline",
                     final)
    assert m, final
    return {"loss": float(m.group(1)), "svd": (m.group(2), m.group(3)),
            "transitions": [l for l in lines
                            if l.startswith("rank transition")],
            "state": next(l for l in lines
                          if l.startswith("optimizer state"))}


def test_launcher_matches_reference_cli(capsys, monkeypatch):
    assert train.main(ARGS + ["--device", "cpu"]) == 0
    port = _closing(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + ARGS)
    jtrain.main()
    ref = _closing(capsys.readouterr().out)
    # the same SVD accounting, the same analytic optimizer state and
    # payload; the losses differ (each package draws its own init)
    assert port["svd"] == ref["svd"] and int(port["svd"][0]) > 0
    assert port["state"] == ref["state"]
    assert port["transitions"] == ref["transitions"] == []
    assert abs(port["loss"] - ref["loss"]) < 0.5


@pytest.mark.parametrize("flag", [["--mesh", "2x1"], ["--tp", "2"],
                                  ["--devices", "2"], ["--compress"],
                                  ["--zero"], ["--zero2", "1"],
                                  ["--multihost"]])
def test_distributed_flags_refused(capsys, flag):
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + ["--device", "cpu"] + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag[0] in err and "ROADMAP queue 1 item 5" in err


def test_launcher_resumes_from_checkpoint(capsys, caplog, tmp_path):
    """6 steps with a checkpoint every 2 steps; with all but the step-2
    checkpoint removed, the same command resumes after step 2 and closes
    as the uninterrupted run did."""
    cmd = ["--arch", "llama-60m", "--smoke", "--batch", "4", "--seq", "32",
           "--device", "cpu", "--accum", "2", "--steps", "6",
           "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    train.main(cmd)
    whole = _closing_plain(capsys.readouterr().out)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000004", "step_00000005"]
    for s in (4, 5):
        shutil.rmtree(tmp_path / f"step_{s:08d}")
    caplog.clear()
    with caplog.at_level("INFO", logger="repro_torch.trainer"):
        train.main(cmd)
    assert "restored checkpoint at step 2" in caplog.text
    assert "step 0 loss" not in caplog.text
    assert _closing_plain(capsys.readouterr().out) == whole


def _closing_plain(out: str) -> str:
    return next(l for l in out.splitlines() if l.startswith("final loss"))


def test_launcher_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama-60m", "--smoke", "--steps", "1"])
