"""The port's checkpointer (``repro_torch.checkpoint``): the reference's
five checkpoint tests (``tests/test_checkpoint.py``) mirrored on the
port's format, an exact bf16 round trip, a failed write reported, and a
resume through ``FaultTolerantRunner``.  The port reads and writes its own
directories only (its format is one ``.npy`` a leaf; ROADMAP C)."""
import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import Checkpointer
from repro_torch.runtime.events import kinds
from repro_torch.runtime.fault_tolerance import FaultTolerantRunner, RunState
from repro_torch.training.optimizer import AdamState


@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(3, dtype=torch.bfloat16)},
            "opt_state": {"step": torch.tensor(5, dtype=torch.int32)}}


def _like(tree):
    return T.map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                       device="meta"), tree)


def test_roundtrip(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(10, tree, blocking=True)
    out = ck.restore(10, _like(tree), device="cpu")
    for a, b in zip(T.leaves(tree), T.leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_restore_latest_and_gc(tmp_path, tree):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree, blocking=True)
    assert ck.latest_step() == 4
    assert ck.all_steps() == [3, 4]          # GC kept the last 2
    step, out = ck.restore_latest(tree)
    assert step == 4 and out is not None


def test_torn_write_ignored(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(7, tree, blocking=True)
    # a crash mid-write: a step dir without the DONE marker
    torn = tmp_path / "step_9"
    torn.mkdir()
    (torn / "params.w.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 7             # 9 is invisible


def test_async_save_completes(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(3, tree, blocking=False)
    ck.wait()
    assert ck.latest_step() == 3


def test_empty_dir(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    step, out = ck.restore_latest(tree)
    assert step is None and out is None


def test_bf16_roundtrip_is_exact(tmp_path):
    """bf16 leaves are widened to fp32 on disk and cast back: every bit
    pattern but NaN's comes back (infinities, subnormals and -0 among
    them; a NaN comes back a NaN, its payload not kept, as in the
    reference's astype), and so do fp32 and int32 leaves; the save copies
    the leaves, so a leaf updated in place while the write runs is saved
    as it was."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    b16 = bits.view(torch.bfloat16)
    f32 = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    tree = {"a": b16, "b": f32, "c": torch.tensor(7, dtype=torch.int32)}
    ck = Checkpointer(tmp_path)
    want = T.map(lambda t: t.clone(), tree)
    ck.save(1, tree)
    tree["b"].add_(1.0)                      # in place, during the write
    ck.wait()
    out = ck.restore(1, _like(want), device="cpu")
    nan = torch.isnan(b16)
    assert torch.equal(out["a"].view(torch.int16)[~nan], bits[~nan])
    assert bool(torch.isnan(out["a"][nan]).all()) and int(nan.sum()) == 254
    assert torch.equal(out["b"], want["b"]) and out["c"].dtype == torch.int32
    stored = np.load(tmp_path / "step_1" / "a.npy")
    assert stored.dtype == np.float32


def test_failed_write_is_reported(tmp_path, tree):
    """A write that fails on its thread raises from ``wait``, and leaves
    no visible step."""
    ck = Checkpointer(tmp_path)
    bad = {"x": torch.zeros(2)}
    (tmp_path / "afile").write_text("a file where a directory goes")
    ck.dir = tmp_path / "afile" / "deeper"
    ck.save(5, bad)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ck.wait()
    assert ck.all_steps() == []


def test_restore_checks_shapes(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, blocking=True)
    like = _like(tree)
    like["params"]["w"] = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, like, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        ck.restore(1, _like(tree))


def _adam_step(params, opt, batch):
    """A toy step: params += batch, the counter advanced."""
    new = {k: v + batch for k, v in params.items()}
    return new, AdamState(step=opt.step + 1, mu=opt.mu, nu=opt.nu), {}


def _state(step=0):
    params = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    opt = AdamState(step=torch.tensor(step, dtype=torch.int32),
                    mu={"w": torch.zeros(3)}, nu={"w": torch.ones(3)})
    return RunState(step=step, params=params, opt_state=opt)


def test_resume_through_the_runner(tmp_path):
    """A runner checkpoints every ``ckpt_every`` steps; a fresh runner
    restores the latest step into a tree of meta tensors on the CPU,
    NamedTuples and dtypes kept, and stepping on from it gives the
    uninterrupted run's state; a step that raises is retried from the
    checkpoint and recorded as ``step_failure``."""
    runner = FaultTolerantRunner(Checkpointer(tmp_path), ckpt_every=2)
    state = _state()
    history = []
    for i in range(5):
        state = runner.run_step(_adam_step, state, float(i))
        history.append(state)
    runner.ckpt.wait()
    assert runner.ckpt.all_steps() == [2, 4]

    fresh = FaultTolerantRunner(Checkpointer(tmp_path), ckpt_every=2)
    like = _state()
    like = RunState(0, _like(like.params), _like(like.opt_state))
    got = fresh.maybe_restore(like, device="cpu")
    assert got.step == 4 and kinds(fresh.events, "restored")
    assert isinstance(got.opt_state, AdamState)
    want = history[3]
    for a, b in zip(T.leaves((got.params, got.opt_state)),
                    T.leaves((want.params, want.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    nxt = fresh.run_step(_adam_step, got, 4.0)
    assert torch.equal(nxt.params["w"], history[4].params["w"])

    calls = {"n": 0}

    def flaky(params, opt, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device fault")
        return _adam_step(params, opt, batch)
    after = fresh.run_step(flaky, nxt, 5.0)
    fails = kinds(fresh.events, "step_failure")
    assert len(fails) == 1 and "injected" in fails[0].get("error")
    # the retry restored step 4 (the latest checkpoint) and stepped once
    assert after.step == 5
    assert torch.equal(after.params["w"], history[4].params["w"] + 1.0)


def test_runner_retries_only_from_a_checkpoint(tmp_path):
    """A step that writes part of its update in place and then raises is
    retried only from a restored checkpoint: with none, the runner
    re-raises after recording ``step_failure`` (a retry on the written
    state would apply the update twice); with one, the retry restores it
    and the step is applied once."""
    def torn(calls):
        def step(params, opt, batch):
            params["w"].add_(batch)                # the in-place update
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected fault after the update began")
            return params, AdamState(step=opt.step + 1, mu=opt.mu,
                                     nu=opt.nu), {}
        return step

    runner = FaultTolerantRunner(Checkpointer(tmp_path / "none"))
    calls = {"n": 0}
    with pytest.raises(RuntimeError, match="injected"):
        runner.run_step(torn(calls), _state(), 1.0)
    assert calls["n"] == 1 and len(kinds(runner.events, "step_failure")) == 1
    assert not kinds(runner.events, "restored")

    runner = FaultTolerantRunner(Checkpointer(tmp_path / "ck"))
    state = _state()
    runner.checkpoint(state, blocking=True)
    calls = {"n": 0}
    after = runner.run_step(torn(calls), state, 1.0)
    assert calls["n"] == 2 and kinds(runner.events, "restored")
    assert after.step == 1
    assert torch.equal(after.params["w"],
                       torch.ones(3, dtype=torch.bfloat16))
