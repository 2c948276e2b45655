"""Training loop with fault tolerance.

Port of ``src/repro/train/trainer.py``:
- periodic async checkpoints (atomic; ``CheckpointManager``);
- exact resume: params, optimizer state and the step's
  ``torch.Generator`` state are checkpointed, so an interrupted run
  resumes bitwise-identically (the reference checkpoints its rng key);
- a SIGTERM hook: snapshot + clean exit;
- straggler-tolerant prefetch: a background thread keeps a bounded queue
  of batches; if the producer stalls past ``stall_timeout_s`` the trainer
  reuses the last good batch and counts the event.
The step runs eagerly (the reference jits it and donates its buffers).
The generator is passed to every step as it is (the reference splits its
key each step); only a step that samples draws from it.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import signal
import tempfile
import threading
import time
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    log_every: int = 10
    stall_timeout_s: float = 5.0
    prefetch_depth: int = 2


class _Prefetcher:
    """Bounded-queue background batch producer with stall fallback."""

    def __init__(self, it: Iterator, depth: int, timeout_s: float):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.timeout_s = timeout_s
        self.stalls = 0
        self._last = None
        self._done = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self.it:
                self.q.put(item)
        finally:
            self._done = True

    def next(self):
        try:
            batch = self.q.get(timeout=self.timeout_s)
            self._last = batch
            return batch
        except queue.Empty:
            if self._last is None:
                raise RuntimeError("data pipeline never produced a batch")
            self.stalls += 1          # straggler mitigation: reuse last batch
            return self._last


class Trainer:
    def __init__(self, train_step: Callable, params, opt_state,
                 data_iter: Iterator, cfg: TrainerConfig,
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.step_fn = train_step
        self.params = params
        self.opt_state = opt_state
        self.generator = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.mgr = CheckpointManager(cfg.ckpt_dir, keep_last=cfg.keep_last)
        self.prefetch = _Prefetcher(data_iter, cfg.prefetch_depth,
                                    cfg.stall_timeout_s)
        self.history: list[float] = []
        self._preempted = False

    # -- fault-tolerance hooks ------------------------------------------------

    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state,
                "rng": self.generator.get_state()}

    def save(self, step: int, asynchronous: bool = True):
        if asynchronous:
            self.mgr.save_async(step, self._state_tree())
        else:
            self.mgr.save(step, self._state_tree())

    def try_restore(self) -> int:
        """Resume from latest checkpoint; returns start step (0 if fresh)."""
        if self.mgr.latest_step() is None:
            return 0
        state, step = self.mgr.restore(self._state_tree())
        self.params, self.opt_state = state["params"], state["opt"]
        self.generator.set_state(state["rng"])
        return step

    # -- loop -----------------------------------------------------------------

    def run(self, start_step: int = 0) -> dict:
        t0 = time.monotonic()
        step = start_step
        while step < self.cfg.total_steps:
            batch = self.prefetch.next()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.generator)
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                loss = float(metrics["loss"])
                self.history.append(loss)
            if step % self.cfg.ckpt_every == 0:
                self.save(step)
            if self._preempted:
                self.save(step, asynchronous=False)
                return {"step": step, "preempted": True,
                        "stalls": self.prefetch.stalls}
        self.mgr.wait()
        return {"step": step, "preempted": False,
                "stalls": self.prefetch.stalls,
                "wall_s": time.monotonic() - t0,
                "history": self.history}
