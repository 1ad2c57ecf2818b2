"""Whether the timed path trains correctly: the port's first steps held
against the reference's steps from the same inputs.

Three numbers are compared, each against its limit (``limits/<cell>``):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: for the first step, the worst leaf's gap between the
  gradient norms (the port's gradient read from its Adam state after one
  step, ``m1 / (1 - beta1)``), against the reference's norm of that leaf
  or of the median leaf, whichever is larger;
- ``step_gap``: the same for the norm of each leaf's change over the
  compared steps;
- ``grad_median_gap``: for the first step, the worst leaf's median over
  its elements (those with a non-zero reference gradient) of the
  relative gap of the gradients. A gap of norms swings with the few
  pixels where the two sides' float32 arithmetic takes a threshold (the
  alpha cutoff, the transmittance stop, a grazing ray) differently; the
  median does not, and it moves where every element moves a little, as
  under a lower-precision chart stream.

A fifth, ``rechart_gap``, checks the trainer's first re-chart as a stage
of its own: the reference re-charts the port's charts as they stood
before it (log-scales, texture, dims) and the largest of these gaps to
the port's result is compared: the share of surfels whose dims differ,
the texel scale's and the mappings' relative gaps, and the texture's
largest gap over its largest texel. The compared steps hold no re-chart:
a re-chart's dims are a discontinuous function of the scales, and a
reference re-charting its own, rounding-apart scales may resample a
chart at another size.

Leaves whose reference gradient is under a thousandth of the median
leaf's (``features_dc``, which the render does not read at SH degree > 0)
count in neither.
"""

from __future__ import annotations

import statistics

from .reference import gstex_ref as ref

NAMES = ("loss_gap", "grad_gap", "step_gap", "grad_median_gap",
         "rechart_gap")
QUIET_LEAF = 1e-3


def reference_run(first: dict, views, gts, background, st: ref.Settings,
                  device):
    """The reference's steps over the compared views from the port's
    starting params (the benchmark's inputs)."""
    p0 = {k: v.to(device) for k, v in first["params0"].items()}
    cams = [views[i] for i in first["views"]]
    imgs = [gts[i] for i in first["views"]]
    records, params = ref.follow(p0, cams, imgs, first["step0"], background,
                                 st, first["chunks"])
    return records, params


def rechart_gap(rechart: dict, st: ref.Settings, device) -> float:
    """The reference's re-chart of the port's charts as they stood before
    the port's re-chart, against the port's result."""
    before = {k: v.to(device) for k, v in rechart["before"].items()}
    after = {k: v.to(device) for k, v in rechart["after"].items()}
    pad = tuple(before["texture"].shape[1:3])
    hw, mappings, scale = ref.chart_dims(before["log_scales"], st, pad)
    texture = ref.resample(before["texture"], before["texture_hw"], hw)
    dims = float((hw != after["texture_hw"]).any(-1).float().mean())
    scale_gap = float((after["pixel_scale"] - scale).abs() / scale.abs())
    map_gap = float((after["mappings"] - mappings).abs().max()
                    / mappings.abs().max())
    tex_gap = float((after["texture"] - texture).abs().max()
                    / texture.abs().max())
    return max(dims, scale_gap, map_gap, tex_gap)


def readings(first: dict, records, ref_params, st: ref.Settings,
             device) -> dict:
    """The three numbers, with the per-leaf norms they come from."""
    p0 = first["params0"]
    beta = 1.0 - ref.BETA1
    g_ref = {k: (0.0 if g is None else float(g.norm()))
             for k, g in records[0].grads.items()}
    g_prog = {k: float(first["moments1"][k].norm()) / beta for k in g_ref}
    d_ref = {k: float((ref_params[k].cpu() - p0[k]).norm()) for k in g_ref}
    d_prog = {k: float((first["params1"][k] - p0[k]).norm()) for k in g_ref}
    median_g = statistics.median(g_ref.values())
    counted = [k for k in g_ref if g_ref[k] >= QUIET_LEAF * median_g]

    def worst(prog, refn):
        mid = statistics.median(refn[k] for k in counted)
        gaps = {k: abs(prog[k] - refn[k]) / max(refn[k], mid, 1e-30)
                for k in counted}
        leaf = max(gaps, key=gaps.get)
        return gaps[leaf], leaf, gaps

    medians = {}
    for k in counted:
        gr = records[0].grads[k].detach().float()
        gp = first["moments1"][k].to(gr.device) / beta
        live = gr != 0
        medians[k] = float(((gp - gr).abs()[live] / gr.abs()[live]).median())
    median_leaf = max(medians, key=medians.get)
    loss_gaps = [abs(a - r.loss) / abs(r.loss)
                 for a, r in zip(first["losses"], records)]
    grad_gap, grad_leaf, grad_gaps = worst(g_prog, g_ref)
    step_gap, step_leaf, step_gaps = worst(d_prog, d_ref)
    return {"loss_gap": max(loss_gaps), "grad_gap": grad_gap,
            "rechart_gap": rechart_gap(first["rechart"], st, device),
            "step_gap": step_gap, "grad_median_gap": medians[median_leaf],
            "grad_median_leaf": median_leaf, "grad_medians": medians,
            "grad_leaf": grad_leaf,
            "step_leaf": step_leaf, "counted": counted,
            "losses": first["losses"],
            "ref_losses": [r.loss for r in records],
            "grad_gaps": grad_gaps, "step_gaps": step_gaps,
            "grad_norms": g_ref, "step_norms": d_ref}


def verdict(values: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the compared numbers."""
    rows = [(k, float(values[k]), float(limits[k])) for k in NAMES]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
