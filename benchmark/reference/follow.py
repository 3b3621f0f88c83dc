"""The reference's run of a cell's first iteration.

Given the weights made from the seed and the trajectory the program's env
fleet produced in its first iteration (frames, actions taken, rewards,
dones, the warm-up frames), :func:`follow` works out again, in plain
PyTorch, what the program computed from them:

- the obs-norm warm-up (``obs_rms`` from the warm-up frames);
- every act of the rollout: logits and both values of each step and the
  bootstrap, and each step's Gumbel scores ``log softmax - log q`` (the
  action the program samples is the argmax of its own scores);
- the update's batch preparation: RND intrinsic rewards with the
  pre-update ``obs_rms``, the reward filter and its RMS, dual GAE and the
  mixed advantages, the post-update ``obs_rms`` for the RND input;
- the first ``steps`` minibatch steps of the first epoch: each step's loss,
  the first step's gradient as Adam gets it, and every parameter's change
  after the last step.

Every draw (dropout bits, Gumbel noise, the epoch permutation, the RND
update mask) is replayed from generators seeded as the program's
(``prng.py``). The trajectory's frames, actions, rewards and dones are the
program's outputs; the reference reads them as the data it is judged on.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from benchmark.reference import model as M
from benchmark.reference.prng import generators

BLOCK = 1024  # frames per reference call outside the minibatch steps


def _rms_init(shape, device):
    return [torch.zeros(shape, dtype=torch.float64, device=device),
            torch.ones(shape, dtype=torch.float64, device=device),
            torch.tensor(1e-4, dtype=torch.float64, device=device)]


def _rms_merge(state, mean, var, count):
    m0, v0, c0 = state
    delta = mean - m0
    tot = c0 + count
    m2 = v0 * c0 + var * count + delta * delta * c0 * count / tot
    return [m0 + delta * count / tot, m2 / tot, tot]


def _rms_fold(state, frames_u8: torch.Tensor):
    """Fold a batch of frames (moments over the first axis) into ``state``."""
    device = state[0].device
    s = torch.zeros_like(state[0])
    sq = torch.zeros_like(state[0])
    for blk in frames_u8.split(BLOCK):
        x = blk.to(device).double()
        s += x.sum(dim=0)
        sq += (x * x).sum(dim=0)
    n = frames_u8.shape[0]
    mean = s / n
    return _rms_merge(state, mean, sq / n - mean * mean, float(n))


def _normalize(state, x: torch.Tensor) -> torch.Tensor:
    mean, var = state[0].float(), state[1].float()
    return torch.clamp((x.float() - mean) / torch.sqrt(var), -5.0, 5.0)


def gae(reward, done, value, gamma, lam):
    """``(target, adv)`` of rewards ``[N, T]`` and values ``[N, T+1]``."""
    not_done = 1.0 - done
    delta = reward + gamma * value[:, 1:] * not_done - value[:, :-1]
    adv = torch.zeros_like(reward)
    run = torch.zeros_like(reward[:, 0])
    for t in reversed(range(reward.shape[1])):
        run = delta[:, t] + gamma * lam * not_done[:, t] * run
        adv[:, t] = run
    return adv + value[:, :-1], adv


def _act_draws(hp, host, dev, n, device) -> None:
    """The draws of one act, without its arithmetic (acts the reference
    does not compare, such as the device env's warm-up rollouts)."""
    d = M.Draws(host, dev, device, live=True)
    shape = (n, hp["tokens"], hp["dim"])
    d.drop16(shape, hp["emb_dropout"])
    for _ in range(hp["depth"]):
        d.words(hp["dropout"])
        d.drop16(shape, hp["dropout"])
        d.words(hp["dropout"])
    torch.empty((n, hp["actions"]), device=device).exponential_(1.0, generator=dev)


def follow(hp: Dict[str, Any], weights: Dict[str, torch.Tensor], cap: Dict[str, Any],
           device, lower: bool = False, steps: int = 3) -> Dict[str, Any]:
    P = M.Precision(lower)
    host, dev = generators(hp["rng_seed"], device)
    W = {k: v.detach().clone().to(device) for k, v in weights.items()}
    T, N, A = hp["num_step"], hp["num_envs"], hp["actions"]
    out: Dict[str, Any] = {}

    # obs-norm warm-up
    if hp["env"] == "host":
        torch.randint(0, 2 ** 31 - 1, (1,), generator=host)  # the random actions' seed
    obs_rms = _rms_init((1,) + tuple(hp["frame"]), device)
    for batch in cap["warm_obs"]:
        if hp["env"] == "device":
            for _ in range(T + 1):
                _act_draws(hp, host, dev, N, device)
        obs_rms = _rms_fold(obs_rms, batch)

    # the rollout's acts
    values = torch.empty((T + 1, N, 2))
    logits = torch.empty((T, N, A))
    scores = torch.empty((T, N, A))
    with torch.no_grad():
        for t in range(T + 1):
            stack = cap["states"][t] if t < T else cap["final"]
            lg, ve, vi = M.policy(P, W, hp, stack.to(device), M.Draws(host, dev, device, True))
            q = torch.empty((N, A), device=device).exponential_(1.0, generator=dev)
            values[t, :, 0], values[t, :, 1] = ve.cpu(), vi.cpu()
            if t < T:
                logits[t] = lg.cpu()
                scores[t] = (torch.log_softmax(lg, dim=-1) - torch.log(q)).cpu()
    out.update(values=values, logits=logits, scores=scores)

    # the batch preparation
    with torch.no_grad():
        next_obs = cap["next_obs"].transpose(0, 1).reshape((N * T,) + tuple(cap["next_obs"].shape[2:]))
        intr = torch.cat([
            torch.mean(torch.square(
                M.rnd_target(P, W, _normalize(obs_rms, b.to(device)))
                - M.rnd_predictor(P, W, _normalize(obs_rms, b.to(device)))), dim=-1)
            for b in next_obs.split(BLOCK)]).reshape(N, T)
        rewems = torch.zeros(N, device=device)
        rows = []
        for t in range(T):
            rewems = rewems * hp["int_gamma"] + intr[:, t]
            rows.append(rewems)
        flat = torch.stack(rows).reshape(-1).double()
        rr = _rms_merge([torch.tensor(0.0, dtype=torch.float64, device=device),
                         torch.tensor(1.0, dtype=torch.float64, device=device),
                         torch.tensor(1e-4, dtype=torch.float64, device=device)],
                        flat.mean(), flat.var(unbiased=False), float(T))
        intr = intr / torch.sqrt(rr[1]).float()
        v = values.to(device)
        reward = torch.clamp(cap["rewards"].to(device).T.float(), -1.0, 1.0)
        done = cap["dones"].to(device).T.float()
        ext_tgt, ext_adv = gae(reward, done, v[:, :, 0].T, hp["gamma"], hp["lam"])
        int_tgt, int_adv = gae(intr, torch.zeros_like(intr), v[:, :, 1].T, hp["int_gamma"],
                               hp["lam"])
        adv = (int_adv * hp["int_coef"] + ext_adv * hp["ext_coef"]).reshape(-1)
        obs_rms = _rms_fold(obs_rms, next_obs)
    out.update(adv=adv.cpu(), ext_target=ext_tgt.reshape(-1).cpu(),
               int_target=int_tgt.reshape(-1).cpu())

    # the first minibatch steps
    states = cap["states"].transpose(0, 1).reshape((N * T,) + tuple(cap["states"].shape[2:]))
    actions = cap["actions"].T.reshape(-1).to(device)
    old_logits = logits.transpose(0, 1).reshape(N * T, A).to(device)
    adv, ext_tgt, int_tgt = adv, ext_tgt.reshape(-1), int_tgt.reshape(-1)
    names = sorted(k for k in W if M.trainable(k))
    start = {k: W[k].clone() for k in names}
    for k in names:
        W[k].requires_grad_(True)
    m = {k: torch.zeros_like(W[k]) for k in names}
    s2 = {k: torch.zeros_like(W[k]) for k in names}
    b1, b2 = 0.9, 0.999
    perm = torch.randperm(N * T, generator=dev, device=device)
    bs = (N * T) // hp["mini_batch"]
    losses: List[float] = []
    scales: List[float] = []  # the sum of the loss terms' magnitudes
    for step in range(steps):
        idx = perm[step * bs:(step + 1) * bs]
        lg, ve, vi = M.policy(P, W, hp, states[idx.cpu()].to(device),
                              M.Draws(host, dev, device, True))
        a = actions[idx]
        logp_all = torch.log_softmax(lg, dim=-1)
        logp = logp_all.gather(-1, a[:, None])[:, 0]
        logp_old = torch.log_softmax(old_logits[idx], dim=-1).gather(-1, a[:, None])[:, 0]
        entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1)
        ratio = torch.exp(logp - logp_old)
        ad = adv[idx]
        actor = -torch.minimum(ratio * ad, torch.clamp(ratio, 1 - hp["ppo_eps"],
                                                       1 + hp["ppo_eps"]) * ad).mean()
        critic = (torch.square(ve - ext_tgt[idx]).mean()
                  + torch.square(vi - int_tgt[idx]).mean())
        frames = next_obs[idx.cpu()].to(device)
        x = _normalize(obs_rms, frames)
        with torch.no_grad():
            target = M.rnd_target(P, W, x)
        mask_u = torch.rand(bs, generator=dev, device=device)
        per = torch.mean(torch.square(M.rnd_predictor(P, W, x) - target), dim=-1)
        sel = (mask_u < hp["update_proportion"]).float()
        rl = (per * sel).sum() / torch.clamp(sel.sum(), min=1.0)
        loss = actor + 0.5 * critic - hp["ent_coef"] * entropy.mean() + rl
        grads = torch.autograd.grad(loss, [W[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(W[k]) if g is None else g for k, g in zip(names, grads)]
        losses.append(float(loss.detach()))
        scales.append(float((actor.abs() + 0.5 * critic.abs()
                             + hp["ent_coef"] * entropy.mean().abs() + rl.abs()).detach()))
        if hp["clip"]:
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            if float(norm) >= hp["max_grad_norm"]:
                grads = [g * (hp["max_grad_norm"] / norm) for g in grads]
        if step == 0:
            out["grads"] = {k: g.detach().cpu() for k, g in zip(names, grads)}
        with torch.no_grad():
            t = step + 1
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = s2[k].sqrt() / (1 - b2 ** t) ** 0.5 + hp["adam_eps"]
                W[k].sub_(hp["lr"] / (1 - b1 ** t) * m[k] / denom)
    out["loss"], out["loss_scale"] = losses, scales
    out["change"] = {k: (W[k].detach() - start[k]).cpu() for k in names}
    return out
