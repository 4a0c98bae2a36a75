"""The comparison that decides ``correct`` for a training cell.

Both sides train from the same weights on the same first batches (three
steps). What is compared, each against a limit of the cell's own
(``limits`` in its workload file):

- ``loss_gap``: the largest gap, in nats, between the program's loss and the
  reference's over the steps;
- ``grad_gap``: the first gradient as the optimizer holds it (Adam's first
  moment after step 1); for the worst leaf, the gap between the two sides'
  norms over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``update_gap``: each weight's change over the steps, measured alike,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (such as a key's bias, whose exact gradient is zero
  under the softmax, and which Adam moves by round-off alone).

A leaf is one layer's tensor: each leaf the family's layout marks as
layer-stacked counts as its layers.
A non-finite reading is infinitely far.
"""

from __future__ import annotations

import math
import statistics

EXCLUDE_BELOW = 1e-3


def slice_norms(named: dict, stacked: set) -> dict:
    """``{leaf: norm}`` with each tensor whose path is in ``stacked`` cut
    into its layers, in float64."""
    out = {}
    for path, t in named.items():
        t = t.detach()
        if path in stacked:
            for i in range(t.shape[0]):
                out[f"{path}[{i}]"] = float(t[i].double().norm())
        else:
            out[path] = float(t.double().norm())
    return out


def readings(losses: list, mu: dict, change: dict, stacked: set) -> dict:
    return {"loss": [float(x) for x in losses], "grad": slice_norms(mu, stacked),
            "change": slice_norms(change, stacked)}


def _worst(side: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    median = statistics.median(ref[k] for k in leaves)
    worst = 0.0
    for k in leaves:
        gap = abs(side[k] - ref[k]) / max(ref[k], median)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def gaps(side: dict, ref: dict) -> dict:
    """The three numbers compared, of ``side`` against ``ref``."""
    loss = max((abs(a - b) for a, b in zip(side["loss"], ref["loss"])), default=math.inf)
    if len(side["loss"]) != len(ref["loss"]) or not math.isfinite(loss):
        loss = math.inf
    median_grad = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= EXCLUDE_BELOW * median_grad]
    return {"loss_gap": loss, "grad_gap": _worst(side["grad"], ref["grad"], ref["grad"]),
            "update_gap": _worst(side["change"], ref["change"], moving)}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, ``{name: {value, limit}}``)."""
    checks = {name: {"value": found[name], "limit": limits[name]} for name in found}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def program_mu_and_params(state) -> tuple[dict, dict]:
    """The program's Adam first moments and master weights by path."""
    from polyaxon_tpu_torch.models.transformer import flatten

    paths = ["/".join(p) for p, _ in flatten(state.params)]
    mu = list(state.opt_state.mu)
    if len(mu) != len(paths):
        raise RuntimeError(f"{len(mu)} first moments for {len(paths)} leaves")
    return dict(zip(paths, mu)), {"/".join(p): t for p, t in flatten(state.params)}
