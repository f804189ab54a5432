"""The port's training launcher (``repro_torch.launch.train``) against the
JAX package's CLI (``repro.launch.train``), both called in-process: the
same closing lines (SVD accounting; under ``--adaptive-rank`` the rank
transitions and the optimizer state's size), data-parallel and
tensor-parallel runs on gloo ranks it starts itself (``--devices``,
``--tp``, ``--mesh DxM``), meshes that do not fit the ranks refused by
name, a resume through ``--checkpoint-dir``, and no silent fallback to
the CPU."""
import contextlib
import io
import re
import shutil
import sys

import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train
from torch_one_thread import one_thread  # noqa: F401

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


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--mesh", "2x2"],
                                  ["--mesh", "1x2"],
                                  ["--devices", "2", "--tp", "3"]])
def test_distributed_flags_refused(capsys, flag):
    """A mesh that does not fit the ranks is refused by name: a
    tensor-parallel degree that does not divide them, a mesh of another
    size than the world."""
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + ["--device", "cpu"] + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag[-2] in err and ("divisor" in err or "needs" in err)


def test_multihost_needs_torchrun(capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + ["--device", "cpu", "--multihost"])
    assert e.value.code == 2 and "torchrun" in capsys.readouterr().err


DP = ["--devices", "2", "--mesh", "2x1", "--compress"]
TP = ["--devices", "2", "--compress"]


@pytest.fixture(scope="module")
def one_process():
    """The one-process run's closing lines."""
    cap = io.StringIO()
    with contextlib.redirect_stdout(cap):
        assert train.main(ARGS + ["--device", "cpu"]) == 0
    return _closing(cap.getvalue())


@pytest.mark.parametrize("flags", [DP, DP + ["--zero"],
                                   DP + ["--zero", "--zero2", "1"],
                                   DP + ["--zero", "--zero2", "0"],
                                   TP + ["--tp", "2"], TP + ["--mesh", "1x2"]],
                         ids=["compress", "zero", "zero2", "zero-no-zero2",
                              "tp", "mesh-1x2"])
def test_data_parallel_launch(capsys, one_process, flags):
    """Two gloo ranks train llama-60m smoke and close with the one-process
    run's SVD accounting, optimizer state and payload: data-parallel, and
    tensor-parallel on the (1, 2) mesh (at the smoke shapes only the head,
    vocab 512, holds whole blocks a rank and shards)."""
    one = one_process
    assert train.main(ARGS + ["--device", "cpu"] + flags) == 0
    dp = _closing(capsys.readouterr().out)
    assert dp["svd"] == one["svd"] and int(dp["svd"][0]) > 0
    assert dp["state"] == one["state"]
    assert dp["transitions"] == one["transitions"] == []
    assert abs(dp["loss"] - one["loss"]) < 1e-2


def test_zero2_without_zero_refused():
    """As the reference's trainer refuses it: an explicit ZeRO-2 that
    cannot take effect."""
    with pytest.raises(ValueError, match="zero2=True requires a mesh, "
                       "zero_shard=True, and compress_dp_grads=True"):
        train.main(ARGS + ["--device", "cpu"] + DP + ["--zero2", "1"])


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
