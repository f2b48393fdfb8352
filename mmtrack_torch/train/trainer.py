"""Epoch loop, telemetry, checkpoints and fail-safe restart, port of
mmtrack_tpu/train/trainer.py (:23-189; ViPT lib/train/trainers/
base_trainer.py:62-230, ltr_trainer.py:61-191).

Checkpoints are `torch.save` of the model, optimizer and scheduler state
dicts with the step and epoch, written to a temporary file in the
checkpoint directory and renamed into place (`os.replace`), so a crash
never leaves a partial checkpoint under a checkpoint's name. Under data
parallelism (a CheckpointManager given a `shard` of several ranks) rank 0
alone writes, and every rank lists and reads after a barrier, so a resume
or a fail-safe restart reads what rank 0 has written.
"""

from __future__ import annotations

import os
import re
import tempfile
import time
import traceback

import torch

from mmtrack_torch.parallel.mesh import SINGLE, Shard
from mmtrack_torch.train.train_step import TrainState


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class CheckpointManager:
    """Atomic checkpoints `epoch_NNNN.pt`, the newest `keep_last` kept."""

    _NAME = re.compile(r"epoch_(\d+)\.pt")

    def __init__(self, directory: str, save_interval: int = 1, keep_last: int = 2,
                 shard: Shard = SINGLE):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval = save_interval
        self.keep_last = keep_last
        self.shard = shard

    def should_save(self, epoch: int, total_epochs: int) -> bool:
        return epoch % self.save_interval == 0 or epoch == total_epochs

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:04d}.pt")

    def epochs(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := self._NAME.fullmatch(f)))

    def save(self, epoch: int, state: TrainState) -> None:
        if self.shard.rank == 0:
            self._write(epoch, state)
        self.shard.barrier()

    def _write(self, epoch: int, state: TrainState) -> None:
        payload = {"epoch": epoch, "step": state.step, "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "scheduler": state.scheduler.state_dict()}
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
            os.replace(tmp, self._path(epoch))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.epochs()[:-self.keep_last]:
            os.unlink(self._path(old))

    def latest_epoch(self) -> int | None:
        self.shard.barrier()
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: int, state: TrainState) -> TrainState:
        """Load checkpoint `epoch` into `state` in place and return it."""
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(epoch), map_location=device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.step = payload["step"]
        return state


class Trainer:
    """Epoch loop around a train step.

    train(max_epochs, load_latest=True, fail_safe=True) resumes from the
    newest checkpoint, and on an exception mid-epoch reloads the last
    checkpoint and retries (up to 10 times) instead of dying.
    `step_for_epoch(epoch) -> train_step` swaps the step on schedule
    boundaries (the quantized CE keep-rate anneal).
    """

    def __init__(self, train_step, state: TrainState, loader,
                 checkpoints: CheckpointManager | None = None, print_interval: int = 50,
                 log_fn=print, val_loader=None, val_step=None, val_epoch_interval: int = 0,
                 step_for_epoch=None, tb_writer=None):
        self.train_step = train_step
        self.state = state
        self.loader = loader
        self.checkpoints = checkpoints
        self.print_interval = print_interval
        self.log = log_fn
        self.val_loader = val_loader
        self.val_step = val_step      # (state, batch) -> (state, stats); must not update
        self.val_epoch_interval = val_epoch_interval
        self.step_for_epoch = step_for_epoch
        self.tb_writer = tb_writer    # optional, with write_epoch(dict, epoch)
        self.epoch = 0
        self.stats_history: list[dict] = []
        self.val_history: list[dict] = []

    def _resume(self) -> None:
        if self.checkpoints is None:
            return
        latest = self.checkpoints.latest_epoch()
        if latest is not None:
            self.state = self.checkpoints.restore(latest, self.state)
            self.epoch = latest
            self.log(f"resumed from checkpoint epoch {latest}")

    def train_epoch(self) -> dict:
        meters: dict[str, AverageMeter] = {}
        data_time = AverageMeter()
        step_time = AverageMeter()
        t_prev = time.perf_counter()
        n_frames = 0
        for i, batch in enumerate(self.loader):
            t_data = time.perf_counter()
            data_time.update(t_data - t_prev)
            self.state, stats = self.train_step(self.state, batch)
            stats = {k: float(v) for k, v in stats.items()}   # waits for the step
            t_step = time.perf_counter()
            step_time.update(t_step - t_data)
            t_prev = t_step
            n_frames += len(batch["search"])
            for k, v in stats.items():
                meters.setdefault(k, AverageMeter()).update(v)
            if (i + 1) % self.print_interval == 0:
                fps = n_frames / max(data_time.sum + step_time.sum, 1e-9)
                self.log(f"epoch {self.epoch} [{i + 1}/{len(self.loader)}] "
                         + ", ".join(f"{k}: {m.avg:.4f}" for k, m in meters.items())
                         + f", fps: {fps:.1f}, data: {data_time.avg * 1e3:.0f}ms"
                         + f", step: {step_time.avg * 1e3:.0f}ms")
        return {k: m.avg for k, m in meters.items()}

    def validate(self) -> dict:
        meters: dict[str, AverageMeter] = {}
        for batch in self.val_loader:
            _, stats = self.val_step(self.state, batch)
            for k, v in stats.items():
                meters.setdefault(k, AverageMeter()).update(float(v))
        out = {f"val/{k}": m.avg for k, m in meters.items()}
        self.log(f"epoch {self.epoch} validation: "
                 + ", ".join(f"{k}: {v:.4f}" for k, v in out.items()))
        return out

    def train(self, max_epochs: int, load_latest: bool = True, fail_safe: bool = True) -> None:
        if load_latest:
            self._resume()
        num_tries = 10 if fail_safe else 1
        for attempt in range(num_tries):
            try:
                while self.epoch < max_epochs:
                    self.epoch += 1
                    if self.step_for_epoch is not None:
                        self.train_step = self.step_for_epoch(self.epoch)
                    epoch_stats = self.train_epoch()
                    self.stats_history.append(epoch_stats)
                    if self.tb_writer is not None:
                        self.tb_writer.write_epoch({"train": epoch_stats}, self.epoch)
                    if (self.val_loader is not None and self.val_epoch_interval
                            and self.epoch % self.val_epoch_interval == 0):
                        self.val_history.append(self.validate())
                        if self.tb_writer is not None:
                            self.tb_writer.write_epoch({"val": self.val_history[-1]},
                                                       self.epoch)
                    if (self.checkpoints is not None
                            and self.checkpoints.should_save(self.epoch, max_epochs)):
                        self.checkpoints.save(self.epoch, self.state)
                return
            except Exception:
                if attempt == num_tries - 1:
                    raise
                self.log("training crashed; restarting from last checkpoint\n"
                         + traceback.format_exc())
                self.epoch = max(self.epoch - 1, 0)
                self._resume()
