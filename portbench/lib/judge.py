"""The numbers that decide `correct`, each held against its limit."""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

PIXEL_QUANTILE = 0.9        # of an image's pixels, for logit_gap


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Program against reference over the checked steps:
    loss_gap      the worst over the checked steps of |loss − the
                  reference's| / |the reference's|;
    grad_gap      over the trainable leaves, the largest gap between the
                  norms of the first step's clipped gradient (the
                  program's as its optimizer holds it), over the larger of
                  the reference leaf's norm and the median leaf's;
    change_gap    the same gap, the worst leaf, for each leaf's change
                  after the last checked step, leaving out leaves whose
                  reference gradient is under a thousandth of the median
                  leaf's (round-off alone moves them);
    change_median_gap  the median over those leaves of the same gap (an
                  update wrong on every leaf by a little);
    trainable_mismatch  leaves trainable on one side only."""
    loss_gap = _worst(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    rg, pg = ref["grad_norms"], prog["grad_norms"]
    med_g = statistics.median(rg.values())
    grad_gap = _worst(abs(pg.get(n, 0.0) - g) / max(g, med_g) for n, g in rg.items())
    gaps = change_gaps(prog, ref)
    nan = any(g != g for g in gaps.values())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": _worst(gaps.values()),
            "change_median_gap": float("inf") if nan else statistics.median(gaps.values()),
            "trainable_mismatch": float(len(set(pg) ^ set(rg)))}


def change_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Per leaf that the reference's gradient moves, the gap between the
    norms of its change, over the larger of the leaf's and the median
    leaf's reference norm."""
    rg = ref["grad_norms"]
    med_g = statistics.median(rg.values())
    kept = [n for n, g in rg.items() if g >= 1e-3 * med_g]
    rc, pc = ref["change_norms"], prog["change_norms"]
    med_c = statistics.median(rc[n] for n in kept)
    return {n: abs(pc.get(n, 0.0) - rc[n]) / max(rc[n], med_c) for n in kept}


def image_gaps(prog_logits: torch.Tensor, ref_logits: torch.Tensor,
               q: float = PIXEL_QUANTILE) -> float:
    """The q-quantile over an image's pixels of the largest class-logit gap."""
    gap = (prog_logits.float() - ref_logits.float()).abs().amax(dim=0).flatten()
    return float(torch.quantile(gap, q))


def eval_numbers(pairs: List[tuple]) -> Dict[str, float]:
    """pairs: (program logits (C, H0, W0), reference logits (C, H0, W0),
    program labels (H0, W0), reference labels (H0, W0)) per checked image,
    the logits after the resize to the original size.
    logit_gap       the worst image's 90th percentile over pixels of the
                    largest class-logit gap (a pixel whose group
                    assignment sits on a tie may flip, and pixels of a
                    group whose class affinities are steep read larger;
                    a wrong window, a wrong image or a lower precision
                    moves far more than a tenth of an image's pixels);
    label_mismatch  the share of original-size pixels whose label differs;
    unchecked       1 where no answer of the window was checked."""
    if not pairs:
        return {"logit_gap": float("inf"), "label_mismatch": 1.0, "unchecked": 1.0}
    gaps, wrong, total = [], 0, 0
    for pl, rl, plab, rlab in pairs:
        if pl.shape != rl.shape or plab.shape != rlab.shape:
            return {"logit_gap": float("inf"), "label_mismatch": 1.0, "unchecked": 0.0}
        gaps.append(image_gaps(pl, rl))
        wrong += int((plab != rlab).sum())
        total += plab.numel()
    return {"logit_gap": _worst(gaps), "label_mismatch": wrong / total, "unchecked": 0.0}


def _worst(values) -> float:
    """The largest value; infinity where any is not a number."""
    values = list(values)
    return float("inf") if any(v != v for v in values) else max(values)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit; a number without a limit, or a
    limit without a number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(numbers[k] <= limits[k] for k in numbers)
