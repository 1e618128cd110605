"""The port's train CLI (``python -m repro_torch.launch.train``) on the CPU:
``--smoke --device cpu`` trains the reduced stablelm-3b and its probe loss
falls; ``--resume`` continues from the saved step and lands where an
uninterrupted run does; its flags and defaults are the reference CLI's
(``src/repro/launch/train.py``), but for ``--ckpt-dir`` (the port's
format lives in a directory of its own, under TMPDIR) and the port's
``--device``."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import train as jtrain
from repro_torch import tree as T
from repro_torch.launch import train as ttrain

ROOT = Path(__file__).resolve().parents[1]


class _Seen(Exception):
    pass


def _reference_args(argv, monkeypatch):
    """The reference CLI's namespace and TrainConfig for ``argv``, captured
    before it builds anything."""
    seen = {}

    def train_config(**kw):
        seen["train_cfg"] = kw
        raise _Seen
    real_parse = jtrain.argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        seen["args"] = real_parse(self, args, namespace)
        return seen["args"]
    monkeypatch.setattr(jtrain, "TrainConfig", train_config)
    monkeypatch.setattr(jtrain.argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Seen):
        jtrain.main(argv)
    monkeypatch.undo()
    return vars(seen["args"]), seen["train_cfg"]


@pytest.mark.parametrize("argv", [[], ["--smoke"], ["--steps", "40",
                                                    "--microbatches", "2",
                                                    "--grad-compression",
                                                    "int8"]])
def test_cli_defaults_match_the_reference(argv, monkeypatch):
    want_args, want_cfg = _reference_args(argv, monkeypatch)
    args = ttrain.parse_args(argv)
    got = vars(args)
    assert set(got) - set(want_args) == {"device"}
    assert got["device"] is None
    for key in want_args:
        if key != "ckpt_dir":
            assert got[key] == want_args[key], key
    assert Path(got["ckpt_dir"]).name == "repro_torch_ckpt"
    cfg = ttrain.train_config(args)
    for key, value in want_cfg.items():
        assert getattr(cfg, key) == value, key
    assert cfg.remat == ("none" if "--smoke" in argv else "dots")
    if not argv:
        assert (args.arch, args.steps, args.batch, args.seq, args.lr) == \
            ("stablelm-3b", 200, 8, 128, 1e-3)


def _run(tmp_path, *extra):
    args = ttrain.parse_args(["--smoke", "--device", "cpu", "--batch", "4",
                              "--seq", "16", "--log-every", "3",
                              "--ckpt-dir", str(tmp_path), *extra])
    return ttrain.run(args)


def test_smoke_run_loss_falls_and_resume_continues(tmp_path):
    """9 steps with a checkpoint every 6: the probe loss falls.  A 12-step
    run cut after its step-9 checkpoint (the later ones removed, as if it
    had died there) and run again with ``--resume`` restores step 9 and
    ends bit-equal to an uninterrupted 12-step run, params and optimizer
    state: ``batch_at`` is a pure function of the step."""
    first = _run(tmp_path / "a", "--steps", "9", "--ckpt-every", "6")
    losses = first["losses"]
    assert first["logged"] == [3, 6, 9] and losses[-1] < losses[0]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert first["runner"].ckpt.all_steps() == [6, 9]

    whole = _run(tmp_path / "b", "--steps", "12")
    cut = _run(tmp_path / "c", "--steps", "12", "--ckpt-every", "9")
    ckpt = cut["runner"].ckpt
    assert ckpt.all_steps() == [9, 12]
    shutil.rmtree(ckpt.dir / "step_12")
    again = _run(tmp_path / "c", "--steps", "12", "--resume")
    assert again["runner"].events[0].kind == "restored" and \
        again["runner"].events[0].tick == 9
    assert again["logged"] == [12] and len(again["step_ms"]) == 3
    for a, b in zip(T.leaves((again["state"].params,
                              again["state"].opt_state)),
                    T.leaves((whole["state"].params,
                              whole["state"].opt_state))):
        assert torch.equal(a, b)


def test_cli_module_runs(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` as a
    user runs it."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "4", "--log-every", "2", "--batch",
         "2", "--seq", "8", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "TMPDIR": str(tmp_path), "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] done: first loss" in out.stdout
    assert (tmp_path / "stablelm-3b" / "step_4" / "DONE").exists()


def test_cli_without_a_card_refuses():
    """Without ``--device cpu`` the CLI wants the card and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run(ttrain.parse_args(["--smoke", "--steps", "1"]))
