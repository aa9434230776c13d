"""The window's model products over its wall time and the card's fp32
peak, %: per step the encoder's forward and backward on the source
views, and per query its in-body samples (the query's own mask) times
the transformer's and MLP's products, three times for a plain query and
six for one that takes the occupancy normal (``work.train_step_flops``)."""

from benchmark.harness.work import (
    FLOPS_FP32, encoder_flops, point_flops, train_step_flops)


def read(run):
    w = run.window
    if not w["units"] or not w.get("queries"):
        return None
    v, _, h, wd = w["images"]
    enc = encoder_flops(v, h, wd, run.cfg["widths"]["encoder_blocks"])
    per_point = point_flops(run.cfg["widths"])
    steps = {}
    for step, n_body, normals in w["queries"]:
        steps.setdefault(step, []).append((n_body, normals))
    flops = sum(train_step_flops(enc, per_point, q) for q in steps.values())
    return 100.0 * flops / (w["wall_s"] * FLOPS_FP32)
