"""Fault-tolerant training loop (the counterpart of ``repro.train.loop``).

The reference's behaviours, on one device:

* **checkpoint/restart** — periodic async checkpoints; on start, the loop
  restores the newest committed checkpoint (params, optimizer moments, data
  cursor) and resumes bit-exactly (the synthetic pipeline is replayable by
  step);
* **crash containment** — a step that raises (device OOM, NaN guard, or an
  injected fault in tests) triggers restore-from-checkpoint and replay
  instead of aborting; past ``max_restores`` failures it re-raises;
* **straggler accounting** — per-step wall times are tracked; steps slower
  than ``straggler_factor ×`` the running median are counted and surfaced;
* **NaN guard** — a non-finite loss aborts the step and restores, rather
  than poisoning the weights.

The step updates the state in place (``adam_step``), so a restore copies
the checkpoint into the loop's own tensors (``restore_latest_into``): a
step that failed half way leaves nothing behind. A step's wall ends in a
synchronisation of the parameters' device (the reference's
``jax.block_until_ready``). The final save is skipped when the last step
was just checkpointed (the reference writes the same state twice). The
reference's elastic re-shard on restore is out of scope (README).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..device import synchronize
from ..models.convert import leaves
from .checkpoint import Checkpointer
from .data import TokenStream


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    max_restores: int = 3
    straggler_factor: float = 2.0


class FaultTolerantLoop:
    def __init__(self, *, train_step: Callable, params, opt_state,
                 stream: TokenStream, ckpt: Checkpointer,
                 loop_cfg: LoopConfig = LoopConfig(),
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.stream = stream
        self.ckpt = ckpt
        self.cfg = loop_cfg
        self.fault_hook = fault_hook
        self.step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.restores = 0
        self.straggler_steps = 0
        self._saved_step: Optional[int] = None
        self._device = next(iter(leaves(params))).device

    # ------------------------------------------------------------- recovery
    def _restore(self) -> bool:
        got = self.ckpt.restore_latest_into(
            {"params": self.params, "opt": self.opt_state})
        if got is None:
            return False
        step, _, extra = got
        self.step = int(extra.get("data_step", step))
        return True

    def _save(self) -> None:
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state},
                       extra={"data_step": self.step})
        self._saved_step = self.step

    # ----------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        if self._restore():
            pass                                  # resumed
        else:
            self._save()                          # step-0 baseline
        walls: List[float] = []
        while self.step < self.cfg.total_steps:
            batch = self.stream.batch(self.step)
            try:
                if self.fault_hook is not None:
                    self.fault_hook(self.step)    # test-injected crash
                t0 = time.perf_counter()
                params, opt, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at "
                                             f"step {self.step}: {loss}")
                synchronize(self._device)
                wall = time.perf_counter() - t0
            except Exception:
                self.restores += 1
                if self.restores > self.cfg.max_restores:
                    raise
                restored = self._restore()
                if not restored:
                    raise
                continue                           # replay from checkpoint
            # commit
            self.params, self.opt_state = params, opt
            self.step += 1
            walls.append(wall)
            if len(walls) > 5:
                med = float(np.median(walls[-50:]))
                if wall > self.cfg.straggler_factor * med:
                    self.straggler_steps += 1
            if self.step % self.cfg.log_every == 0:
                self.metrics_log.append(
                    {"step": self.step, "loss": loss, "wall": wall})
            if self.step % self.cfg.checkpoint_every == 0:
                self._save()
        if self._saved_step != self.step:
            self._save()
        self.ckpt.wait()
        return {
            "final_step": self.step,
            "restores": self.restores,
            "stragglers": self.straggler_steps,
            "log": self.metrics_log,
        }
