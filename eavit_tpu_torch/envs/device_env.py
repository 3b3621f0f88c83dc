"""The synthetic room-explorer as tensor functions on the agent's device.

Counterpart of ``eavit_tpu/envs/device_env.py`` (``EnvType =
synthetic_device``): the env is a pair of plain functions on tensors, so a
whole rollout (act -> step -> buffer) runs on the card with no host
involvement until the update (``rl/scan_rollout.py``).

Dynamics match :class:`eavit_tpu_torch.envs.synthetic.SyntheticAtariEnv`
without sticky actions: a walk on a ``grid x grid`` torus of pre-rendered
rooms; +1 reward for each first visit (or, in sparse-goal mode, only at the
goal room, which ends the episode); truncation at ``max_episode_steps`` with
auto-reset; observations are 4-frame uint8 stacks. The worlds (room frames,
maze walls, goal rooms) are built once on the host from numpy generators
seeded as ``eavit_tpu`` seeds them, so they are the JAX package's bit for
bit. :func:`device_env_step` is branch-free and reads and writes through
``index_select`` / ``gather`` / ``scatter`` only, so it never waits for the
host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class DeviceEnvParams(NamedTuple):
    frames: torch.Tensor  # [W, G, G, V, H, W] uint8 pre-rendered room variants
    walls: torch.Tensor  # [W, G, G, 4] bool: blocked (up, down, left, right)
    grid: int
    stack: int
    max_episode_steps: int
    # sparse-goal mode (None = dense first-visit rewards): [W] int32 room
    # index of the single rewarded cell per world; reaching it pays +1 and
    # ends the episode
    goal_rooms: Optional[torch.Tensor] = None
    # the leading "world" dim W is num_envs for per-env worlds, or 1 for
    # shared_world (stored once)


class DeviceEnvState(NamedTuple):
    pos: torch.Tensor  # [N, 2] int32
    steps: torch.Tensor  # [N] int32
    visited: torch.Tensor  # [N, G*G] bool (per episode, reset on done)
    ever_visited: torch.Tensor  # [N, G*G] bool (cumulative, never reset)
    episode_reward: torch.Tensor  # [N] f32
    stack: torch.Tensor  # [N, C, H, W] uint8
    # episode bookkeeping aggregates
    finished_episodes: torch.Tensor  # [N] int32
    last_episode_return: torch.Tensor  # [N] f32
    last_episode_rooms: torch.Tensor  # [N] int32


def _maze_walls(grid: int, rng: np.random.Generator) -> np.ndarray:
    """DFS spanning-tree maze: [G, G, 4] blocked flags (up/down/left/right).

    Only corridors of the spanning tree are open, so random walks cover the
    map poorly (``eavit_tpu/envs/device_env.py:54-82``).
    """
    walls = np.ones((grid, grid, 4), bool)
    visited = np.zeros((grid, grid), bool)
    stack = [(0, 0)]
    visited[0, 0] = True
    # (dy, dx, dir_index, opposite_dir_index)
    moves = [(-1, 0, 0, 1), (1, 0, 1, 0), (0, -1, 2, 3), (0, 1, 3, 2)]
    while stack:
        y, x = stack[-1]
        nbrs = []
        for dy, dx, d, od in moves:
            ny, nx = y + dy, x + dx
            if 0 <= ny < grid and 0 <= nx < grid and not visited[ny, nx]:
                nbrs.append((ny, nx, d, od))
        if not nbrs:
            stack.pop()
            continue
        ny, nx, d, od = nbrs[rng.integers(len(nbrs))]
        walls[y, x, d] = False
        walls[ny, nx, od] = False
        visited[ny, nx] = True
        stack.append((ny, nx))
    return walls


def _bfs_distances(walls: np.ndarray) -> np.ndarray:
    """[G, G, 4] blocked flags -> [G, G] BFS distance from (0, 0).

    Honors walls; moves wrap on the torus (matching device_env_step's
    modulo arithmetic). Unreachable cells get -1."""
    g = walls.shape[0]
    dist = np.full((g, g), -1, np.int64)
    dist[0, 0] = 0
    frontier = [(0, 0)]
    moves = [(-1, 0, 0), (1, 0, 1), (0, -1, 2), (0, 1, 3)]
    while frontier:
        nxt = []
        for y, x in frontier:
            for dy, dx, d in moves:
                if walls[y, x, d]:
                    continue
                ny, nx = (y + dy) % g, (x + dx) % g
                if dist[ny, nx] < 0:
                    dist[ny, nx] = dist[y, x] + 1
                    nxt.append((ny, nx))
        frontier = nxt
    return dist


def goal_room_for_depth(walls: np.ndarray, goal_depth: int) -> int:
    """Flat room index of the sparse-goal cell for one world's walls.

    goal_depth=0: the BFS-farthest cell from the (0, 0) spawn. goal_depth>0:
    the reachable cell whose BFS depth is closest to the target, ties broken
    toward the deeper cell (lexicographic argmin of (|d - target|, -d))."""
    dist = _bfs_distances(walls)
    if goal_depth > 0:
        grid = walls.shape[0]
        d = np.where(dist >= 0, dist, -(10 ** 9))
        score = np.abs(d - goal_depth) * (2 * grid * grid) - d
        return int(np.argmin(score))
    return int(np.argmax(dist))


def make_device_env(
    num_envs: int,
    seed: int = 42,
    grid: int = 8,
    stack: int = 4,
    height: int = 84,
    width: int = 84,
    max_episode_steps: int = 128,
    maze: bool = False,
    texture: str = "sine",
    shared_world: bool = False,
    variants: int = 1,
    sparse_goal: bool = False,
    goal_depth: int = 0,
    device="cpu",
) -> Tuple[DeviceEnvParams, DeviceEnvState]:
    """Build the room frames on the host (once), move them to ``device`` and
    return ``(params, initial state)`` (``eavit_tpu/envs/device_env.py:
    129-235``).

    ``maze`` restricts movement to a DFS spanning-tree maze per world;
    ``texture`` is ``"sine"`` (a smooth two-phase sinusoid per room, the
    host synthetic env's family) or ``"noise"`` (uniform random bytes per
    room); ``shared_world`` gives every env env 0's world, stored once;
    ``variants > 1`` pre-renders V frames per room and shows variant
    ``steps % V``; ``sparse_goal`` rewards only the goal room that
    :func:`goal_room_for_depth` picks.
    """
    n_worlds = 1 if shared_world else num_envs
    cells = np.empty(
        (n_worlds, grid, grid, variants, height, width), np.uint8
    )
    if texture == "noise":
        for i in range(n_worlds):
            pat_rng = np.random.default_rng((seed + i) * 7919 + 13)
            cells[i] = pat_rng.integers(
                0, 256, (grid, grid, variants, height, width), dtype=np.uint8
            )
    elif texture == "sine":
        yy = np.linspace(0, 4 * np.pi, height)[:, None]
        xx = np.linspace(0, 4 * np.pi, width)[None, :]
        idx = np.arange(grid * grid).reshape(grid, grid)
        for i in range(n_worlds):
            pat_rng = np.random.default_rng((seed + i) * 7919 + 13)
            phase = pat_rng.uniform(0, 2 * np.pi, size=(grid, grid, variants, 2))
            c = 127.5 * (
                1
                + np.sin(yy[None, None, None] + phase[..., 0:1, None])
                * np.cos(xx[None, None, None] + phase[..., 1:2, None])
            )
            c += 40.0 * (idx[..., None, None, None] / (grid * grid))
            cells[i] = np.clip(c, 0, 255).astype(np.uint8)
    else:
        raise ValueError(f"unknown texture: {texture!r}")

    if maze:
        walls = np.stack(
            [
                _maze_walls(grid, np.random.default_rng((seed + i) * 104729 + 7))
                for i in range(n_worlds)
            ]
        )
    else:
        walls = np.zeros((n_worlds, grid, grid, 4), bool)

    device = torch.device(device)
    goal_rooms = None
    if sparse_goal:
        goals = [goal_room_for_depth(walls[i], goal_depth) for i in range(n_worlds)]
        goal_rooms = torch.tensor(goals, dtype=torch.int32, device=device)

    params = DeviceEnvParams(
        frames=torch.from_numpy(cells).to(device),
        walls=torch.from_numpy(walls).to(device),
        grid=grid,
        stack=stack,
        max_episode_steps=max_episode_steps,
        goal_rooms=goal_rooms,
    )
    return params, device_env_reset(params, num_envs)


def _world_idx(params: DeviceEnvParams, n: int) -> torch.Tensor:
    """Per-env world index: identity for per-env worlds, all 0 when the
    world is shared (stored once)."""
    return torch.arange(n, device=params.frames.device) % params.frames.shape[0]


def _cell_index(params: DeviceEnvParams, pos: torch.Tensor) -> torch.Tensor:
    """[N, 2] positions -> [N] int64 flat (world, y, x) index."""
    g = params.grid
    w = _world_idx(params, pos.shape[0])
    return (w * g + pos[:, 0].long()) * g + pos[:, 1].long()


def _frame_at(params: DeviceEnvParams, pos: torch.Tensor,
              steps: torch.Tensor) -> torch.Tensor:
    """([N, 2], [N]) -> [N, H, W] room frames (variant = steps % V)."""
    v = params.frames.shape[3]
    flat = _cell_index(params, pos) * v + (steps.long() % v)
    return params.frames.reshape((-1,) + tuple(params.frames.shape[-2:])).index_select(0, flat)


def _first_visit_row(n: int, cells: int, device) -> torch.Tensor:
    """[N, G*G] bool with only room 0 set."""
    out = torch.zeros((n, cells), dtype=torch.bool, device=device)
    out[:, 0] = True
    return out


def device_env_reset(params: DeviceEnvParams, num_envs: int) -> DeviceEnvState:
    dev = params.frames.device
    cells = params.grid * params.grid
    pos = torch.zeros((num_envs, 2), dtype=torch.int32, device=dev)
    frame = _frame_at(params, pos, torch.zeros(num_envs, dtype=torch.int32, device=dev))
    return DeviceEnvState(
        pos=pos,
        steps=torch.zeros(num_envs, dtype=torch.int32, device=dev),
        visited=_first_visit_row(num_envs, cells, dev),
        ever_visited=_first_visit_row(num_envs, cells, dev),
        episode_reward=torch.zeros(num_envs, dtype=torch.float32, device=dev),
        stack=frame[:, None].repeat(1, params.stack, 1, 1),
        finished_episodes=torch.zeros(num_envs, dtype=torch.int32, device=dev),
        last_episode_return=torch.zeros(num_envs, dtype=torch.float32, device=dev),
        last_episode_rooms=torch.zeros(num_envs, dtype=torch.int32, device=dev),
    )


def device_env_step(
    params: DeviceEnvParams, state: DeviceEnvState, actions: torch.Tensor
) -> Tuple[DeviceEnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One vectorised step (``eavit_tpu/envs/device_env.py:273-346``).
    Returns ``(state', rewards f32, dones bool, truncated bool)``.

    Actions: 0 noop, 1 up, 2 down, 3 left, 4 right on a torus; a move into a
    wall keeps the position; +1 for a first visit (dense) or at the goal room
    (sparse, which also ends the episode); truncation at the cap; auto-reset
    to room (0, 0) with a fresh visit set and a reset-filled stack. The
    cumulative ``ever_visited`` survives resets."""
    g = params.grid
    n = actions.shape[0]
    a = actions.long()
    dy = (a == 2).long() - (a == 1).long()
    dx = (a == 4).long() - (a == 3).long()
    # direction index: 0 up, 1 down, 2 left, 3 right (noop mapped to 0 but
    # gated by moved)
    dir_idx = (a - 1).clamp(0, 3)
    moved = a > 0
    blocked = params.walls.reshape(-1).index_select(
        0, _cell_index(params, state.pos) * 4 + dir_idx)
    allow = (moved & ~blocked).long()
    pos = torch.stack([(state.pos[:, 0].long() + dy * allow) % g,
                       (state.pos[:, 1].long() + dx * allow) % g], dim=1).to(torch.int32)
    room = (pos[:, 0].long() * g + pos[:, 1].long())[:, None]
    first_visit = ~state.visited.gather(1, room)[:, 0]
    visited = state.visited.scatter(1, room, True)
    ever_visited = state.ever_visited.scatter(1, room, True)
    if params.goal_rooms is None:
        reward = first_visit.float()
        dones = torch.zeros(n, dtype=torch.bool, device=a.device)
    else:
        goal = params.goal_rooms.index_select(0, _world_idx(params, n))
        at_goal = room[:, 0] == goal.long()
        reward = at_goal.float()
        dones = at_goal
    episode_reward = state.episode_reward + reward
    steps = state.steps + 1

    truncated = (steps >= params.max_episode_steps) & ~dones
    reset = dones | truncated

    frame = _frame_at(params, pos, steps)
    shifted = torch.cat([state.stack[:, 1:], frame[:, None]], dim=1)

    pos0 = torch.zeros_like(pos)
    frame0 = _frame_at(params, pos0, torch.zeros_like(steps))
    visited0 = _first_visit_row(n, g * g, a.device)

    r = reset[:, None]
    new_state = DeviceEnvState(
        pos=torch.where(r, pos0, pos),
        steps=torch.where(reset, torch.zeros_like(steps), steps),
        visited=torch.where(r, visited0, visited),
        ever_visited=ever_visited,  # cumulative discovery survives resets
        episode_reward=torch.where(reset, torch.zeros_like(episode_reward), episode_reward),
        stack=torch.where(reset[:, None, None, None], frame0[:, None], shifted),
        finished_episodes=state.finished_episodes + reset.to(torch.int32),
        last_episode_return=torch.where(reset, episode_reward, state.last_episode_return),
        last_episode_rooms=torch.where(reset, visited.sum(dim=1).to(torch.int32),
                                       state.last_episode_rooms),
    )
    return new_state, reward, dones, truncated
