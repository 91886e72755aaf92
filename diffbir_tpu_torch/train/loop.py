"""What the stage-1 and stage-2 trainers share: the device and the
processes, checkpoints and resume, the data iterator, tensorboard.

- Device and processes: each process drives the card ``LOCAL_RANK`` names
  (``parallel.distributed.local_device``; cuda raises without a card); the
  process group (``run_trainer`` starts it from the DIFFBIR_* or torchrun
  environment and destroys it at the end) sets the data-parallel size,
  held to ``train.n_data`` and the batch (``parallel.mesh.data_size``).
- Checkpoints: the full training state (``MasterAdamW.state_dict``, whole
  masters and moments, plus the step) under
  ``exp_dir/checkpoints/<step>.pt``; the three newest kept (orbax's
  ``max_to_keep=3``). Every process gathers, rank 0 writes, then a barrier
  (JAX's ``sync_processes("ckpt")``); the file is the same for any process
  count, so a sharded run's checkpoint resumes in one process and back.
- Resume: ``train.resume: <step>`` restores that state when it is truthy,
  as JAX's ``if tcfg.get("resume")``: ``0``, ``null`` and absence train from
  step 0.
- Data: ``dataset.as_iterator`` at ``batch_size // processes`` from
  ``process_seed(train.seed)``, with ``native=True`` under
  ``train.native_loader`` when the C++ loader builds (else JAX's
  "unavailable, python fallback" line and the Python path), through
  ``PrefetchIterator``: the transform in its worker thread, the batch staged
  on the device.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Dict, List, Optional

import torch

from ..parallel.distributed import (
    is_main_process,
    local_device,
    maybe_initialize_distributed,
    process_seed,
    shutdown_distributed,
    sync_processes,
)
from ..parallel.mesh import DataParallel, broadcast_, data_size
from .optim import MasterAdamW

KEEP_CHECKPOINTS = 3
DEFAULT_SEED = 231


def tensorboard(exp_dir: str):
    """tensorboardX's writer under ``exp_dir/tb``, or None when the package
    does not import."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(exp_dir, "tb"))


def run_trainer(build: Callable[[], "TrainerBase"], device: str) -> "TrainerBase":
    """``build()`` then ``run()`` a trainer inside the process group that
    the launch environment asks for (started here, destroyed at the end)."""
    started = maybe_initialize_distributed(local_device(device))
    try:
        return build().run()
    finally:
        if started:
            shutdown_distributed()


class TrainerBase:
    """The state of a training loop that its subclass fills: ``model``
    (the module whose parameters are trained), ``optimizer``, ``step``;
    ``REDUCE`` is how the loss, and so the gradients, combine over the
    processes ("sum" or "mean")."""

    REDUCE = "mean"

    def __init__(self, cfg: Dict, device="cuda"):
        self.cfg, self.tcfg = cfg, cfg["train"]
        self.device = local_device(device)
        self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.batch_size = int(self.tcfg["batch_size"])
        self.n_data = data_size(self.tcfg.get("n_data"), self.batch_size)
        self.main = is_main_process()
        self.parallel = DataParallel(self.REDUCE, fsdp=bool(self.tcfg.get("fsdp", False)))
        self.exp_dir = self.tcfg["exp_dir"]
        self.ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.native = self._native_loader()
        self.step = 0
        self.last_saved: Optional[int] = None
        self.optimizer: Optional[MasterAdamW] = None
        # host seconds per step: waiting on the data, the whole step without
        # its checkpoint (it ends in a device sync where the step logs: the
        # loss is read), and the checkpoints' saves
        self.wait_seconds: List[float] = []
        self.step_seconds: List[float] = []
        self.save_seconds: List[float] = []
        self.losses: List[float] = []

    def log(self, msg: str) -> None:
        if self.main:
            print(msg, flush=True)

    def _native_loader(self) -> bool:
        if not self.tcfg.get("native_loader", False):
            return False
        from ..dataset.native_loader import native_available

        native = native_available()
        self.log(f"native C++ data loader: {'on' if native else 'unavailable, python fallback'}")
        return native

    def replicate_(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers of ``module`` on every process."""
        broadcast_(module.state_dict().values())
        if self.parallel.active:
            self.log(f"data parallel over {self.n_data} processes, global batch "
                     f"{self.batch_size} ({self.batch_size // self.n_data} each), gradients "
                     f"{'averaged' if self.parallel.mean else 'summed'}"
                     + (", optimiser state sharded (fsdp)" if self.parallel.fsdp else ""))

    def maybe_resume(self) -> None:
        """Restore ``train.resume``'s checkpoint when the value is truthy."""
        if self.tcfg.get("resume"):
            self.restore(int(self.tcfg["resume"]))
            self.log(f"resumed @ {self.step}")

    # ------------------------------------------------------------------ #
    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{step}.pt")

    def saved_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      (re.fullmatch(r"(\d+)\.pt", n) for n in os.listdir(self.ckpt_dir)) if m)

    def state(self) -> Dict:
        """The full training state, on the host (every process calls this
        together)."""
        return {"step": self.step, **self.optimizer.state_dict()}

    def save(self) -> None:
        """The full state under ``checkpoints/`` (three newest kept), written
        by rank 0 after every process has gathered it."""
        state = self.state()
        if self.main:
            path = self.checkpoint_path(self.step)
            torch.save(state, path + ".tmp")
            os.replace(path + ".tmp", path)
            for old in self.saved_steps()[:-KEEP_CHECKPOINTS]:
                os.remove(self.checkpoint_path(old))
        self.last_saved = self.step
        sync_processes("ckpt")

    @torch.no_grad()
    def restore(self, step: int) -> None:
        path = self.checkpoint_path(step)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"train.resume: {step}: no checkpoint {path} (saved: "
                                    f"{self.saved_steps() or 'none'})")
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.optimizer.load_state_dict(state)
        self.step = self.last_saved = int(state["step"])

    def save_last(self) -> None:
        """A loop that ends between checkpoints saves a last one."""
        if self.last_saved != self.step:
            self.save()

    # ------------------------------------------------------------------ #
    def batches(self, ds, transform: Optional[Callable] = None):
        """The prefetching iterator of this process's batches of ``ds``,
        transformed in the worker thread and staged on the device."""
        from ..dataset.prefetch import PrefetchIterator, to_device

        bs, seed = self.batch_size // self.n_data, process_seed(int(self.tcfg.get("seed",
                                                                                   DEFAULT_SEED)))
        src = (ds.as_iterator(bs, seed=seed, native=True) if self.native
               else ds.as_iterator(bs, seed=seed))
        return PrefetchIterator(src, transform=transform, device_put=to_device(self.device))

    def next_batch(self, it) -> Dict:
        """``next(it)``, its wait recorded."""
        t0 = time.perf_counter()
        batch = next(it)
        self.wait_seconds.append(time.perf_counter() - t0)
        return batch

    def run(self) -> "TrainerBase":  # pragma: no cover - overridden
        raise NotImplementedError
