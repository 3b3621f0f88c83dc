"""Observability: console and file logging, scalars, profiler hooks.

Counterpart of ``eavit_tpu/utils/logger.py`` (reference utils.py:188-509):
dual console/file loggers, scalars with per-tag step counters, and an
"N updates, then exit" profiling mode. Scalars always go to
``<log_dir>/<log_name>_scalars.jsonl`` (one JSON object per call); they are
mirrored to TensorBoard when ``tensorboardX`` is importable and to wandb when
asked for and importable -- neither package is required. The profiler is
``torch.profiler`` (CPU and, with a GPU, CUDA activities); the trace is
written as a Chrome trace when profiling ends.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from collections import defaultdict
from typing import Any, Dict, Mapping, Optional

import torch


class Logger:
    def __init__(
        self,
        log_name: str = "eavit",
        log_dir: str = "logs",
        use_tensorboard: bool = True,
        use_wandb: bool = False,
        rank: int = 0,
        verbose: bool = False,
    ):
        self.log_name = log_name
        self.rank = rank
        self.verbose = verbose
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)

        self._logger = logging.getLogger(f"eavit_torch.{log_name}.{rank}")
        self._logger.setLevel(logging.INFO)
        self._close_handlers()
        fmt = logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self._logger.addHandler(sh)
        fh = logging.FileHandler(os.path.join(log_dir, f"{log_name}_rank{rank}.log"))
        fh.setFormatter(fmt)
        self._logger.addHandler(fh)
        self._logger.propagate = False

        self._scalars = None
        if rank == 0:
            self._scalars = open(
                os.path.join(log_dir, f"{log_name}_scalars.jsonl"), "a")

        self.tb = None
        if use_tensorboard and rank == 0:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                self.log("tensorboardX is not installed: scalars go to the jsonl file only")
            else:
                self.tb = SummaryWriter(os.path.join(log_dir, "tb", log_name))

        self.wandb = None
        if use_wandb and rank == 0:
            try:
                import wandb
            except ImportError:
                self.log("wandb is not installed (continuing without)")
            else:
                self.wandb = wandb
                wandb.init(project="eavit_tpu_torch", name=log_name)

        # per-tag auto step counters (reference utils.py:263-267)
        self.tb_global_steps: Dict[str, int] = defaultdict(int)

        # profiling state (reference utils.py:421-509)
        self._profile_remaining = 0
        self._profile_dir: Optional[str] = None
        self._profiler = None

    def _close_handlers(self) -> None:
        for h in list(self._logger.handlers):
            h.close()
            self._logger.removeHandler(h)

    # -- console/file -------------------------------------------------------
    def log(self, msg: str, only_rank_0: bool = False) -> None:
        if only_rank_0 and self.rank != 0:
            return
        self._logger.info(msg)

    log_msg_to_both_console_and_file = log  # reference method-name alias

    # -- scalars -------------------------------------------------------------
    def log_scalars(self, scalars: Mapping[str, Any], step: Optional[int] = None) -> None:
        values = {tag: float(v) for tag, v in scalars.items()}
        if self._scalars is not None:
            self._scalars.write(json.dumps({"step": step, **values}) + "\n")
            self._scalars.flush()
        for tag, v in values.items():
            if self.tb is not None:
                s = step if step is not None else self.tb_global_steps[tag]
                self.tb.add_scalar(tag, v, s)
                if step is None:
                    self.tb_global_steps[tag] += 1
            if self.wandb is not None:
                self.wandb.log({f"wandb_{tag}": v}, step=step)

    def log_params_histograms(self, params: Mapping[str, torch.Tensor],
                              prefix: str) -> None:
        """Parameter or gradient histograms by name (reference
        utils.py:345-419), only under verbose logging with TensorBoard."""
        if not self.verbose or self.tb is None:
            return
        for name, leaf in params.items():
            tag = f"{prefix}/{name}"
            self.tb.add_histogram(tag, leaf.detach().float().cpu().numpy(),
                                  self.tb_global_steps[tag])
            self.tb_global_steps[tag] += 1

    # -- profiler (reference utils.py:421-509: trace N updates, then exit)
    def start_profiling(self, num_updates: int, trace_dir: Optional[str] = None) -> None:
        self._profile_remaining = num_updates
        self._profile_dir = trace_dir or os.path.join(
            self.log_dir, "torch_trace", self.log_name)
        if num_updates > 0:
            os.makedirs(self._profile_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self.log(f"torch.profiler tracing {num_updates} updates -> {self._profile_dir}")

    def step_profiler(self) -> bool:
        """Call once per update. Returns True when profiling just finished
        (the caller exits, as in the reference, utils.py:471-493)."""
        if self._profile_remaining <= 0:
            return False
        self._profile_remaining -= 1
        if self._profile_remaining == 0:
            self._stop_profiler()
            return True
        return False

    def _stop_profiler(self) -> None:
        if self._profiler is None:
            return
        self._profiler.stop()
        trace = os.path.join(self._profile_dir,
                             "trace.json" if self.rank == 0 else f"trace_rank{self.rank}.json")
        self._profiler.export_chrome_trace(trace)
        self._profiler = None
        self.log(f"profiling finished; trace at {trace}")

    def close(self) -> None:
        self._stop_profiler()
        if self.tb is not None:
            self.tb.close()
        if self._scalars is not None:
            self._scalars.close()
            self._scalars = None
        self._close_handlers()
