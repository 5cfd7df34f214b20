"""The port's train loop on one device: async checkpoints, auto-resume,
preemption handling, straggler watchdog, failure injection — the JAX
package's ``repro.runtime.trainer`` without the mesh.

    trainer = Trainer(cfg, peft, opt, ckpt_dir=..., device="cuda")
    trainer.fit(stream, steps=500)

Fault-tolerance contract:
* every ``ckpt_every`` steps the full state (params, adapters, optimizer
  state, step) and the data cursor are saved asynchronously and
  atomically;
* SIGTERM/SIGINT (preemption) during ``fit`` → synchronous checkpoint,
  clean exit; the process's own handlers are back once ``fit`` returns;
* with ``restore='auto'`` the latest checkpoint is loaded and the data
  stream resumes at the exact step;
* ``fail_at_step`` raises mid-run (tests use it to prove restart works).

A step's metrics are read back to the host together, one synchronize per
step; the step count is mirrored on the host, so reading it costs none.
"""

from __future__ import annotations

import json
import signal
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.core.transforms import PEFTConfig
from repro_torch.data.pipeline import DataState
from repro_torch.launch.steps import init_state, make_train_step
from repro_torch.models.api import resolve_device
from repro_torch.optim import GradientTransformation
from repro_torch.runtime.straggler import StepTimer


class Trainer:
    def __init__(self, cfg, peft: PEFTConfig, opt: GradientTransformation,
                 *, ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 restore: str = "auto", seed: int = 0,
                 log_path: Optional[str] = None,
                 fail_at_step: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        self.peft = peft
        self.opt = opt
        self.device = resolve_device(device)
        self.ckpt_every = ckpt_every
        self.fail_at_step = fail_at_step
        self.data_state = DataState()
        self._stop = False
        self._log_f = open(log_path, "a") if log_path else None
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.timer = StepTimer(on_straggler=lambda step, dt, mean: print(
            f"[straggler] step {step}: {dt:.3f}s vs mean {mean:.3f}s",
            flush=True))
        self.step_fn = make_train_step(cfg, peft, opt)

        # ---- init, then restore over it: the fresh state is the template
        self.state = init_state(cfg, peft, opt, seed=seed,
                                device=self.device)
        if self.ckpt and restore == "auto" and \
                latest_step(self.ckpt.root) is not None:
            self.state, extra = self.ckpt.restore(template=self.state)
            self.data_state = DataState.from_dict(extra["data"])
        self._step = int(self.state["step"])

    @property
    def step(self) -> int:
        return self._step

    def _preempt(self, signum, frame):
        self._stop = True

    def _catch_preemption(self) -> dict:
        """Route SIGTERM/SIGINT to a clean stop; returns the handlers
        they had, for ``fit`` to put back."""
        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, self._preempt)
            except ValueError:        # not the main thread
                pass
        return old

    def _batch(self, batch_np: dict) -> dict:
        """The host batch on the device (pinned, asynchronous copy)."""
        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).long()
            if self.device.type != "cuda":
                return t
            return t.pin_memory().to(self.device, non_blocking=True)
        return {k: put(v) for k, v in batch_np.items()}

    def save(self, *, block: bool = False):
        if not self.ckpt:
            return
        self.ckpt.save(self.step, self.state,
                       extra={"data": self.data_state.to_dict()},
                       block=block)

    def fit(self, stream, *, steps: int) -> dict:
        """Run optimizer steps from the stream's cursor until the state's
        step reaches ``steps``; returns the last step's metrics."""
        old_handlers = self._catch_preemption()
        try:
            return self._fit(stream, steps)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, signal.SIG_DFL if handler is None
                              else handler)

    def _fit(self, stream, steps: int) -> dict:
        last_metrics: dict = {}
        while self.step < steps and not self._stop:
            batch = self._batch(stream.batch_at(self.data_state.step))
            self.timer.start()
            self.state, metrics = self.step_fn(self.state, batch)
            values = torch.stack([v.float() for v in metrics.values()])
            metrics = dict(zip(metrics, values.tolist()))  # the one sync
            self._step += 1
            dt = self.timer.stop(self.step)
            self.data_state.step += 1
            last_metrics = dict(metrics, step=self.step, step_time=dt)
            self._log(last_metrics)
            if self.fail_at_step is not None \
                    and self.step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {self.step}")
            if self.ckpt and self.step % self.ckpt_every == 0:
                self.save()
        if self.ckpt:
            self.save(block=True)
            self.ckpt.wait()
        return last_metrics

    def close(self):
        """Stop the checkpoint writer and close the metrics log."""
        if self.ckpt:
            self.ckpt.close()
        if self._log_f:
            self._log_f.close()
            self._log_f = None

    def _log(self, metrics: dict):
        if self._log_f:
            self._log_f.write(json.dumps(metrics) + "\n")
            self._log_f.flush()
