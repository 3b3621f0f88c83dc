"""The numbers that decide ``correct``: the program's first iteration held to
the reference's (``reference/follow.py``).

- ``act_value_err``: the larger of ``|v - v_ref| / |v_ref|`` (norms over
  every act of the rollout and every env) of the extrinsic and intrinsic
  values;
- ``act_logit_err``: the same of the policy logits;
- ``act_choice_gap``: the widest gap by which the action taken lies below
  the best of the reference's Gumbel scores at that step (the program
  samples the argmax of its own scores with the same noise);
- ``batch_err``: the largest relative gap of the prepared advantages, the
  extrinsic and the intrinsic return targets;
- ``loss_err``: the largest ``|L - L_ref|`` of the first three minibatch
  steps' losses, each over the sum of the magnitudes of the reference's
  loss terms (actor, critic, entropy, RND), since the terms cancel;
- ``grad_gap``: by the worst leaf, ``| |g| - |g_ref| |`` of the first
  step's gradient as Adam gets it, over the larger of ``|g_ref|`` of the
  leaf and of the median leaf;
- ``change_gap``: the same of each leaf's change after three steps, over
  the elements whose first reference gradient is at least a thousandth of
  the median leaf's root-mean-square gradient (an element under it moves
  by round-off alone, as a key's bias does under softmax).

A cell compares the numbers that its file (``workloads/<cell>.json``) gives
a limit; the others only ``calibrate.py`` reports.
"""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict

import torch

NAMES = ("act_value_err", "act_logit_err", "act_choice_gap", "batch_err", "loss_err",
         "grad_gap", "change_gap")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den > 0 else float((a - b).norm())


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Per leaf, the gap of two norms over the larger of the reference's
    norm of the leaf and of the median leaf."""
    if not ref:
        return {}
    floor = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) if k in prog else math.inf
            for k in ref}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return max(_leaf_gaps(prog, ref).values(), default=0.0)


def worst_leaves(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """The leaves that set ``grad_gap`` and ``change_gap`` (for calibration)."""
    g = _leaf_gaps(_grad_norms(prog), _grad_norms(ref))
    keep = {k: m for k, m in _moved(ref["grads"]).items() if bool(m.any())}
    c = _leaf_gaps({k: float(prog["change"][k][m].norm()) for k, m in keep.items()},
                   {k: float(ref["change"][k][m].norm()) for k, m in keep.items()})
    return {"grad_gap": max(g, key=g.get), "change_gap": max(c, key=c.get)}


def _grad_norms(side: Dict[str, Any]) -> Dict[str, float]:
    """The program's norms as its optimizer's state gives them, or a
    reference's from its gradients."""
    if "grad_norms" in side:
        return side["grad_norms"]
    return {k: float(g.norm()) for k, g in side["grads"].items()}


def _moved(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per leaf, the elements whose first reference gradient is at least a
    thousandth of the median leaf's root-mean-square gradient; the others
    move under Adam by round-off alone (a key's bias under softmax)."""
    rms = statistics.median(float(g.double().pow(2).mean().sqrt()) for g in grads.values())
    return {k: g.abs() >= 1e-3 * rms for k, g in grads.items()}


def numbers(prog: Dict[str, Any], ref: Dict[str, Any], actions: torch.Tensor) -> Dict[str, float]:
    """The comparison of a side's first iteration (``prog``, with the
    actions it took) with the reference's (``ref``)."""
    T = ref["scores"].shape[0]
    scores = ref["scores"].double()
    taken = scores.gather(-1, actions[:T].long()[..., None])[..., 0]
    out = {
        "act_value_err": max(_rel(prog["values"][..., i], ref["values"][..., i])
                             for i in range(2)),
        "act_logit_err": _rel(prog["logits"], ref["logits"]),
        "act_choice_gap": float((scores.max(dim=-1).values - taken).max()),
        "batch_err": max(_rel(prog[k], ref[k]) for k in ("adv", "ext_target", "int_target")),
        "loss_err": max(abs(a - b) / max(s, 1e-30)
                        for a, b, s in zip(prog["loss"], ref["loss"], ref["loss_scale"])),
        "grad_gap": _leaf_gap(_grad_norms(prog), _grad_norms(ref)),
    }
    keep = {k: m for k, m in _moved(ref["grads"]).items() if bool(m.any())}
    if set(keep) - set(prog["change"]):
        out["change_gap"] = math.inf
    else:
        out["change_gap"] = _leaf_gap(
            {k: float(prog["change"][k][m].norm()) for k, m in keep.items()},
            {k: float(ref["change"][k][m].norm()) for k, m in keep.items()})
    if len(prog["loss"]) != len(ref["loss"]):
        out["loss_err"] = math.inf
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def own_actions(side: Dict[str, Any]) -> torch.Tensor:
    """The actions a reference-like side takes: the argmax of its scores."""
    return side["scores"].argmax(dim=-1)


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(name in nums and nums[name] <= limits[name] for name in limits)
