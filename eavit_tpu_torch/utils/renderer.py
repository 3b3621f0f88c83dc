"""Matplotlib grid renderer for parallel envs (reference utils.py:511-556)
and the intrinsic-reward trace animation (reference make_animation.py): the
port's own copy of ``eavit_tpu/utils/renderer.py``. matplotlib is imported
when a renderer or an animation is made, not with this module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ParallelizedEnvironmentRenderer:
    """Interactive grayscale grid of N env frames."""

    def __init__(self, num_env: int, figsize=(8, 6)):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.num_env = num_env
        rows = int(np.ceil(np.sqrt(num_env)))
        cols = int(np.ceil(num_env / rows))
        self.fig, axs = plt.subplots(rows, cols, figsize=figsize, squeeze=False)
        self.axs = axs.reshape(-1)[:num_env]
        self.images = None
        plt.ion()

    def render(self, obs: np.ndarray) -> None:
        """obs: [num_env, 1, H, W]"""
        obs = np.asarray(obs)
        if self.images is None:
            self.images = [
                ax.imshow(obs[i, 0], cmap="gray", vmin=0, vmax=255)
                for i, ax in enumerate(self.axs)
            ]
            for ax in self.axs:
                ax.axis("off")
        else:
            for i, im in enumerate(self.images):
                im.set_data(obs[i, 0])
        self.fig.canvas.draw_idle()
        self.plt.pause(0.001)

    def close(self) -> None:
        self.plt.ioff()
        self.plt.close(self.fig)


def make_animation(
    trace_path: str, out_path: Optional[str] = None, fps: int = 30
):
    """Animate a pickled intrinsic-reward trace (reference
    make_animation.py:1-35)."""
    import pickle

    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    with open(trace_path, "rb") as f:
        trace = pickle.load(f)
    trace = np.asarray(trace)

    fig, ax = plt.subplots()
    ax.set_xlim(0, len(trace))
    lo, hi = float(trace.min()), float(trace.max())
    if hi <= lo:  # constant trace: avoid a singular y-transform
        lo, hi = lo - 0.5, lo + 0.5
    ax.set_ylim(lo, hi)
    (line,) = ax.plot([], [])
    ax.set_xlabel("step")
    ax.set_ylabel("intrinsic reward")

    def update(i):
        line.set_data(np.arange(i), trace[:i])
        return (line,)

    anim = animation.FuncAnimation(
        fig, update, frames=len(trace), interval=1000 / fps, blit=True
    )
    if out_path:
        anim.save(out_path)
    return anim
