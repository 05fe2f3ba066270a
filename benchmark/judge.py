"""The comparison that decides ``correct``: the plain reference
(:mod:`benchmark.reference`) works out again, from the benchmark's own
inputs, what the timed path produced, and each number compared is the
widest gap between the two.

Pair cells: a sample of the series' pairs, drawn from the seed among the
pairs the window completed; every answer of a sampled pair is compared.
``pose_gap_mm`` is the widest distance, over the eight corners of the
source epoch's bounding box, between the point moved by the program's
transform and by the reference's; ``sigma_gap`` the widest relative gap
between the two standard deviations of any of the six parameters (the
square roots of the VCM's diagonal).

Campaign cells: ``plan_mismatch`` counts the sources whose target in the
program's adaptive plan (``RegPairFile.txt``) differs from the one the
reference's scan finds from the same epochs, for every source or a sample
drawn from the seed (``checked_plan``; each source's scan starts, as the
program's does, from the target of the source before it, so a sampled
source is checked by itself), plus those in which two campaigns of the
window disagree; a sample of the campaign's pairs (the first sampled
sources),
drawn from the seed, is registered again by the reference as the campaign
does it (each epoch prepared once with the 4D SOR multiplier) and compared
as in a pair cell; and the chained (``TransMatrices_toRef.txt`` and the standard deviations
of ``TransParameters_toRef.txt``) and Kalman-smoothed (``*_smoothed``)
series are compared,
epoch by epoch, with the reference's chaining and smoothing of the
program's own pair results (``pairs/pair_NNNN.npz``) in which the sampled
pairs are the reference's.  The chain can only follow the program's pairs
step by step: registering all of them again would outlast the window.
Those numbers enter the same ``pose_gap_mm`` and ``sigma_gap`` (a chained
or smoothed transform moves the corners of its epoch's box).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np


def sample_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for the judge's draws, apart from the inputs' stream."""
    return np.random.default_rng([seed % 2**64, stream])


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """TF32 for float32 matrix products inside the block (the control's
    lower precision), off again after it."""
    import torch

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def reference_config(settings: dict):
    from .reference.config import PiecewiseICPConfig

    return PiecewiseICPConfig(**settings).validate()


def corners(points: np.ndarray) -> np.ndarray:
    """The eight corners of the points' axis-aligned bounding box, f64."""
    lo = points.min(axis=0).astype(np.float64)
    hi = points.max(axis=0).astype(np.float64)
    return np.array([[(lo, hi)[i][0], (lo, hi)[j][1], (lo, hi)[k][2]]
                     for i in (0, 1) for j in (0, 1) for k in (0, 1)])


def pose_gap_mm(t_prog: np.ndarray, t_ref: np.ndarray,
                pts: np.ndarray) -> float:
    """Widest distance, in mm, between ``pts`` moved by the two 4x4s."""
    a = pts @ t_prog[:3, :3].T + t_prog[:3, 3]
    b = pts @ t_ref[:3, :3].T + t_ref[:3, 3]
    return float(1e3 * np.linalg.norm(a - b, axis=1).max())


def stds(vcm: np.ndarray) -> np.ndarray:
    """The six parameters' standard deviations (rad, m) of a 6x6 VCM."""
    return np.sqrt(np.clip(np.diag(np.asarray(vcm, np.float64)), 0.0, None))


def std_gap(std_prog: np.ndarray, std_ref: np.ndarray) -> float:
    """Widest relative gap between two sets of standard deviations."""
    sp, sr = np.asarray(std_prog), np.asarray(std_ref)
    return float(np.max(np.abs(sp - sr) / np.maximum(sr, 1e-300)))


def sigma_gap(vcm_prog: np.ndarray, vcm_ref: np.ndarray) -> float:
    """Widest relative gap between the parameters' standard deviations."""
    return std_gap(stds(vcm_prog), stds(vcm_ref))


def sample_pairs(done: List[int], count: int, seed: int) -> List[int]:
    """``count`` distinct pairs of ``done``, drawn from the seed."""
    pool = sorted(set(done))
    count = min(count, len(pool))
    pick = sample_rng(seed, 1).choice(len(pool), size=count, replace=False)
    return [pool[int(i)] for i in sorted(pick)]


def reference_pair(epochs, i: int, settings: dict, dev) -> Dict:
    """The reference's transform and VCM of pair i, as the pair entry
    calls it."""
    from .reference.models.pairwise import register_pair

    out = register_pair(epochs[i], epochs[i + 1],
                        reference_config(settings), device=dev)
    return {"trans_mat": np.asarray(out.trans_mat),
            "vcm": np.asarray(out.vcm)}


def judge_pairs(answers: List[Dict], epochs, settings: dict, traffic: dict,
                seed: int, dev) -> Dict[str, float]:
    """The numbers compared in a pair cell, over every answer of the
    sampled pairs."""
    pairs = sample_pairs([a["pair"] for a in answers],
                         int(traffic["checked_pairs"]), seed)
    pose, sigma, n = 0.0, 0.0, 0
    for i in pairs:
        ref = reference_pair(epochs, i, settings, dev)
        pts = corners(epochs[i + 1])
        for a in answers:
            if a["pair"] != i:
                continue
            pose = max(pose, pose_gap_mm(a["trans_mat"], ref["trans_mat"],
                                         pts))
            sigma = max(sigma, sigma_gap(a["vcm"], ref["vcm"]))
            n += 1
    return {"pose_gap_mm": pose, "sigma_gap": sigma, "answers_checked": n,
            "pairs_checked": len(pairs)}


# a milligon in radians
MGON = np.pi / 200.0 / 1000.0


def read_series(out_dir, suffix: str) -> tuple:
    """(transforms, standard deviations [rad, m]) of a chained series:
    the 4x4s of ``TransMatrices<suffix>.txt`` (per epoch its timestamp,
    the 4x4 and the 6x6, 12 decimals) and the standard deviations of
    ``TransParameters<suffix>.txt`` (mgon, mm, 10 decimals; the 6x6's
    fixed-point digits hold too few of a variance)."""
    import os

    tok = open(os.path.join(out_dir, f"TransMatrices{suffix}.txt")).read(
        ).split()
    mats, pos = [], 0
    while pos + 53 <= len(tok):
        mats.append(np.array(tok[pos + 1:pos + 17], float).reshape(4, 4))
        pos += 53
    rows = open(os.path.join(out_dir, f"TransParameters{suffix}.txt")
                ).read().splitlines()[1:]
    sd = [np.array(r.split()[7:13], float) for r in rows if r.strip()]
    sd = [np.concatenate([s[:3] * MGON, s[3:] * 1e-3]) for s in sd]
    return mats, sd


def read_plan(path) -> Dict[int, int]:
    plan = {}
    for ln in open(path).read().splitlines():
        parts = ln.split()
        if len(parts) >= 2:
            plan[int(parts[0])] = int(parts[1])
    return plan


def check_plan(epochs, plan: Dict[int, int], sources: List[int],
               settings: dict, campaign: dict, dev) -> tuple:
    """The reference's scan of each of ``sources`` from the target the
    program's plan gave the source before it (epoch 0 for the first), as
    the program's scan goes on from its own last choice.  Returns (the
    sources whose target differs from ``plan``, the probes made)."""
    from .reference.models.plan import PlanSteps

    cfg = reference_config(settings)
    steps = PlanSteps(epochs, cfg.dt_init,
                      float(campaign["overlap_threshold"]), dev)
    wrong, probes = [], []
    for j in sources:
        first = plan.get(j - 1, 0) if j > 1 else 0
        target, _, made = steps.target(j, first)
        probes += made
        if plan.get(j) != target:
            wrong.append(j)
    return wrong, probes


def reference_campaign_pair(epochs, target: int, source: int,
                            settings: dict, dev) -> Dict:
    """Pair (target, source) as a campaign registers it: each epoch
    prepared once with the 4D SOR multiplier, then the two states."""
    from .reference.models.pairwise import prepare_target, register_pair

    cfg = reference_config(settings)
    mult = cfg.sor_std_mult_4d
    ts = prepare_target(epochs[target], cfg, mult, device=dev)
    ss = prepare_target(epochs[source], cfg, mult, device=dev)
    out = register_pair(None, None, cfg, sor_mult=mult, target_state=ts,
                        source_state=ss, device=dev)
    return {"trans_mat": np.asarray(out.trans_mat),
            "vcm": np.asarray(out.vcm)}


def reference_series(pair_mats, pair_vcms, plan, settings: dict):
    """The reference's chained and smoothed series of the given pairs."""
    from .reference.models.chaining import chain_to_reference
    from .reference.models.kalman import kalman_smooth_transforms

    cfg = reference_config(settings)
    chained_t, chained_v = chain_to_reference(pair_mats, pair_vcms, -1, plan)
    out = {"chained": (chained_t, [stds(v) for v in chained_v])}
    if cfg.kalman_enabled:
        sm = kalman_smooth_transforms(chained_t, chained_v,
                                      cfg.kalman_process_noise)
        out["smoothed"] = (sm.trans_mats, [stds(v) for v in sm.covariances])
    return out


def plan_sources(n_epochs: int, traffic: dict, seed: int) -> List[int]:
    """The sources whose plan entry the judge checks, in the order drawn
    from the seed: all of them, or ``checked_plan`` of them."""
    every = list(range(1, n_epochs))
    count = traffic["checked_plan"]
    if count == "all" or int(count) >= len(every):
        order = sample_rng(seed, 2).permutation(len(every))
    else:
        order = sample_rng(seed, 2).choice(len(every), size=int(count),
                                           replace=False)
    return [every[int(i)] for i in order]


def judge_series(answers: List[Dict], epochs, settings: dict,
                 campaign: dict, traffic: dict, seed: int, dev
                 ) -> Dict[str, float]:
    """The numbers compared in a campaign cell over every campaign of
    ``answers``, each {"plan", "pairs": [(tm, vcm)], "chained",
    "smoothed"}."""
    plan = answers[0]["plan"] if answers else {}
    sources = plan_sources(len(epochs), traffic, seed)
    wrong, probes = check_plan(epochs, plan, sources, settings, campaign,
                               dev)
    steps = sorted(sources[:int(traffic["checked_pairs"])])
    refs = {s: reference_campaign_pair(epochs, plan[s], s, settings, dev)
            for s in steps if s in plan}
    box = [corners(e) for e in epochs]
    mismatch, pose, sigma = len(wrong), 0.0, 0.0
    for a in answers:
        mismatch = max(mismatch, len(wrong) + sum(
            1 for j in range(1, len(epochs)) if a["plan"].get(j)
            != plan.get(j)))
        mats = [np.asarray(t) for t, _ in a["pairs"]]
        vcms = [np.asarray(v) for _, v in a["pairs"]]
        for s in refs:
            pose = max(pose, pose_gap_mm(mats[s - 1], refs[s]["trans_mat"],
                                         box[s]))
            sigma = max(sigma, sigma_gap(vcms[s - 1], refs[s]["vcm"]))
            mats[s - 1], vcms[s - 1] = refs[s]["trans_mat"], refs[s]["vcm"]
        ref = reference_series(mats, vcms, a["plan"], settings)
        for key, (r_t, r_v) in ref.items():
            p_t, p_v = a.get(key, ([], []))
            if len(p_t) != len(r_t):
                pose = sigma = float("inf")
                continue
            for k in range(len(r_t)):
                pose = max(pose, pose_gap_mm(p_t[k], r_t[k], box[k + 1]))
                sigma = max(sigma, std_gap(p_v[k], r_v[k]))
    return {"plan_mismatch": mismatch, "pose_gap_mm": pose,
            "sigma_gap": sigma, "answers_checked": len(answers),
            "pairs_checked": len(refs), "plan_checked": len(sources),
            "plan_probes": probes if len(sources) == len(epochs) - 1
            else None}


def campaign_answer(out_dir, n_epochs: int) -> Dict:
    """What a campaign produced, read from its output folder."""
    import os

    pairs = []
    for step in range(1, n_epochs):
        d = np.load(os.path.join(out_dir, "pairs", f"pair_{step:04d}.npz"))
        pairs.append((d["tm"], d["vcm"]))
    ans = {"plan": read_plan(os.path.join(out_dir, "RegPairFile.txt")),
           "pairs": pairs, "chained": read_series(out_dir, "_toRef")}
    if os.path.exists(os.path.join(out_dir,
                                   "TransMatrices_toRef_smoothed.txt")):
        ans["smoothed"] = read_series(out_dir, "_toRef_smoothed")
    return ans
