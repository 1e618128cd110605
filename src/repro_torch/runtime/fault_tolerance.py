"""Failure-handling orchestration for the port's train driver.

Counterpart of the JAX package's ``runtime/fault_tolerance.py``.  Wraps a
step function with:
  - periodic async checkpoints (every ``ckpt_every`` steps),
  - retry-with-restore on transient device errors: from the latest
    checkpoint only.  The reference retries on its immutable state when
    there is no checkpoint; the port's step updates its state in place,
    so a failure then re-raises (ROADMAP C),
  - straggler monitoring hooks (``runtime/straggler.py``).

Each step is timed to a device synchronize where the state lives on a
card, so ``StepTimer`` sees the step's device time and not only the
host's enqueue, and a fault in a kernel surfaces inside the step's retry
(as a ``step_failure`` event) rather than in a later one.  An evicted
straggler is recorded in the same typed stream that the elastic replanner
(``runtime/elastic.py``: ``replan_after_failure``, ``replan_event``)
reads; as in the reference, the runner itself calls no replan.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.checkpoint import Checkpointer
from repro_torch.device import DeviceLike
from repro_torch.runtime.events import event, straggler_event
from repro_torch.runtime.straggler import StepTimer


@dataclass
class RunState:
    step: int
    params: Any
    opt_state: Any


def _sync(tree) -> None:
    for leaf in T.leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


class FaultTolerantRunner:
    def __init__(self, checkpointer: Checkpointer, *, ckpt_every: int = 50,
                 max_retries: int = 3, host_index: int = 0):
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.host = host_index
        self.timer = StepTimer()
        self.events: list = []

    def maybe_restore(self, state: RunState,
                      device: DeviceLike = None) -> RunState:
        restored = self._restore(state, device)
        return state if restored is None else restored

    def _restore(self, state: RunState, device: DeviceLike = None
                 ) -> Optional[RunState]:
        like = {"params": state.params, "opt_state": state.opt_state}
        step, restored = self.ckpt.restore_latest(like, device)
        if step is None:
            return None
        self.events.append(event("restored", step, "runner"))
        return RunState(step=step, params=restored["params"],
                        opt_state=restored["opt_state"])

    def run_step(self, step_fn: Callable, state: RunState, batch
                 ) -> RunState:
        """One step with retry-on-transient-failure semantics."""
        attempt = 0
        while True:
            try:
                t0 = time.time()
                params, opt_state, _metrics = step_fn(
                    state.params, state.opt_state, batch)
                _sync(params)
                verdict = self.timer.record(self.host, time.time() - t0)
                new_state = RunState(state.step + 1, params, opt_state)
                if verdict.action == "checkpoint":
                    # the post-step params belong to step+1: labelling them
                    # with the pre-step counter makes a restore replay an
                    # already-applied update (double-applied step)
                    self.events.append(
                        straggler_event(verdict, new_state.step, "runner"))
                    self.checkpoint(new_state)
                elif verdict.action == "evict":
                    # an evicted host means capacity loss: record the
                    # escalation in the same typed event stream
                    self.events.append(
                        straggler_event(verdict, new_state.step, "runner"))
                    self.checkpoint(new_state)
                elif new_state.step % self.ckpt_every == 0:
                    self.checkpoint(new_state)
                return new_state
            except Exception as e:  # transient device failure path
                attempt += 1
                self.events.append(event("step_failure", state.step,
                                         "runner", error=repr(e)[:200]))
                if attempt > self.max_retries:
                    raise
                # the step writes params, moments and the int8 residual in
                # place, so a step that failed may have applied part of its
                # update: only a restored copy is a sound state to retry
                restored = self._restore(state)
                if restored is None:
                    raise
                state = restored

    def checkpoint(self, state: RunState, blocking: bool = False):
        self.ckpt.save(state.step,
                       {"params": state.params, "opt_state": state.opt_state},
                       blocking=blocking)
