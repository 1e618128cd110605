"""End-to-end training driver of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b

Counterpart of the JAX package's ``launch/train.py``, on its flags and
defaults (``--arch stablelm-3b --steps 200 --batch 8 --seq 128 --lr 1e-3``,
remat ``dots`` unless ``--smoke``), plus ``--device``: the run goes on the
card unless ``--device cpu``.  It seeds the params, trains through
``FaultTolerantRunner`` (async checkpoints with resume, retry, straggler
monitoring) on ``TokenBatcher`` batches that ``Prefetcher`` moves to the
device, and logs the loss on a fixed probe batch.  Every projection runs
in B10 and prefill-style attention in B11, forward and backward (B10,
B12).  ``--smoke`` swaps in the reduced config (CPU-runnable).

Checkpoints go to ``--ckpt-dir``, by default ``repro_torch_ckpt`` under the
temp directory (``TMPDIR``): the port's checkpoints have a format of
their own, so they never share the reference's ``/tmp/repro_ckpt``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.datasets import token_stream
from repro_torch.data.pipeline import Prefetcher, TokenBatcher, to_device
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.runtime.fault_tolerance import FaultTolerantRunner, RunState
from repro_torch.training import trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "int8"))
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless 'cpu'")
    return ap.parse_args(argv)


def train_config(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5),
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression,
                       remat="none" if args.smoke else "dots")


def run(args: argparse.Namespace) -> dict:
    """Train as ``main`` does.  Returns {"losses": the probe losses
    logged, "logged": their steps, "state": the final RunState,
    "runner", "cfg", "train_cfg", "batcher", "step_ms": each step's wall
    ms to a device synchronize}."""
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    train_cfg = train_config(args)
    print(f"[train] arch={cfg.arch_id} params={cfg.param_count() / 1e6:.1f}M "
          f"device={dev} remat={train_cfg.remat}")

    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    params = transformer.init_params(cfg, gen, device=dev)
    opt_state = trainer.init_opt_state(params, train_cfg)
    step_fn = trainer.make_train_step(cfg, train_cfg)

    stream = token_stream(2_000_000 if not args.smoke else 200_000,
                          cfg.vocab_size)
    batcher = TokenBatcher(stream, args.batch, args.seq)
    # a fixed probe batch for the logged loss: per-step training batches
    # differ, so evaluating on "the current batch" measures batch noise,
    # not convergence.  steps+1 sits beyond the training range, though
    # batch_at wraps modulo the stream, so on long runs its windows can
    # overlap trained ones: a fixed probe, not a strict held-out set
    probe = to_device(batcher.batch_at(args.steps + 1), dev)

    ckpt = Checkpointer(Path(args.ckpt_dir) / cfg.arch_id)
    runner = FaultTolerantRunner(ckpt, ckpt_every=args.ckpt_every)
    state = RunState(step=0, params=params, opt_state=opt_state)
    if args.resume:
        state = runner.maybe_restore(state)
        print(f"[train] resumed at step {state.step}")
    # batches from the resumed step on: batch_at is a pure function of
    # the step, so a resumed run sees the batches an uninterrupted one does
    data = Prefetcher((batcher.batch_at(s) for s in range(state.step,
                                                          args.steps)),
                      device=dev)

    losses, logged, step_ms = [], [], []
    t0 = time.time()
    try:
        while state.step < args.steps:
            batch = next(data)
            prev = state
            ts = time.perf_counter()
            state = runner.run_step(step_fn, state, batch)
            step_ms.append((time.perf_counter() - ts) * 1e3)
            if state.step % args.log_every == 0 or state.step == args.steps:
                with torch.no_grad():
                    loss, _ = trainer.loss_fn(state.params, probe, cfg,
                                              train_cfg)
                losses.append(float(loss))
                logged.append(state.step)
                dt = time.time() - t0
                print(f"step {state.step:5d} loss {float(loss):.4f} "
                      f"({dt / max(state.step - (prev.step - 1), 1):.3f}"
                      "s/step)")
                t0 = time.time()
        runner.checkpoint(state, blocking=True)
    finally:
        data.close()
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")
    return dict(losses=losses, logged=logged, state=state, runner=runner,
                cfg=cfg, train_cfg=train_cfg, batcher=batcher,
                step_ms=step_ms)


def main(argv=None):
    return run(parse_args(argv))["losses"]


if __name__ == "__main__":
    main()
