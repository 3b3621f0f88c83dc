"""Named host spans on the profiler's clock.

``span(name)`` marks a stretch of the program's host work. While a
``torch.profiler`` records, it opens ``torch.profiler.record_function(name)``,
so the range lands on the profiler's timeline beside the device's kernels
and copies, and the profiler gives the device time and the idle time under
it. Otherwise it reads the profiler's module flag once and returns one
shared no-op context: no object made, no tensor, no synchronize. A span
never synchronizes and never touches a stream; it gives only the host
interval. ``--profile_updates`` (``utils/logger.py``) writes the spans into
its Chrome trace with the rest.

The spans and their parents (every name starts with ``eavit.``)::

    eavit.iteration          train.iteration: one pass of the training loop's body
      eavit.collect          DeviceRolloutCollector.collect (serial and pipelined),
                             ScanRolloutCollector.collect, RolloutCollector.collect
        eavit.act            one act: the fold of the last outcome (the frame
                             upload), agent.act's launches and the buffer writes;
                             the bootstrap act too (T + 1 a rollout)
        eavit.act_sync       the actions' copy to the host, where the host waits on
                             the card (host-env collectors only)
        eavit.env_step       one env step: the host fleet's step and its record, or
                             device_env_step's launches (T a rollout)
      eavit.update           RNDAgent.update
        eavit.prepare_batch  RNDAgent.prepare_batch
        eavit.minibatch      RNDAgent._minibatch_step (Epoch x MiniBatch of them)
          eavit.forward      the minibatch's loss
          eavit.backward     loss.backward() and the zero-filling of missing grads
          eavit.allreduce    the gradients' mean over the ranks (a no-op without
                             a process group; the span stays)
          eavit.optimizer    the global norm, the clip, Adam's step, the SSL
                             target's EMA
      eavit.readback         every metric read back to a host float

In the pipelined collector a lane's ``eavit.act`` queues its act; that
act's ``eavit.act_sync`` follows the other lane's ``eavit.env_step``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over the host work it wraps: the profiler's range
    ``name`` while a profiler records, else the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
