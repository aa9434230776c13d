"""The window's model products over its wall time and the card's fp32
peak, %: per view the transformer's and the NeRF MLP's products at each
sample within 5 cm of the body (the view's ``ViewStats.n_body``); the
encoder does not run in the window (the source's latent is cached)."""

from benchmark.harness.work import FLOPS_FP32, point_flops


def read(run):
    w = run.window
    if not w["units"] or not w.get("n_body"):
        return None
    flops = point_flops(run.cfg["widths"]) * sum(w["n_body"])
    return 100.0 * flops / (w["wall_s"] * FLOPS_FP32)
