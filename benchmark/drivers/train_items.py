"""Training mixes: the port's one-device training loop on a pool of items,
as its command line drives it: per item ``to_device_input`` and
``Trainer.train_item`` (one optimizer step per output view, the smooth
loss every ``smooth_interval``-th step).

Set-up builds the pool on the host, the seeded model and one ``Trainer``,
and drives it through the first two items by the window's own call.  The
first three steps' inputs (rays, depths, the smooth step's jitter) and
what the optimizer holds when steps 2 and 4 begin (the first gradient,
from Adam's first moment, and the parameters) are kept; the check runs
the plain reference through the same three steps once the window has
closed.  The window cycles through the rest of the pool.

Configuration: ``image_size``, ``cameras``, ``input_views``, ``pair``
(source and target poses of a pair item), ``pair_border``,
``body_ratio``.  Traffic: ``pool``, ``output_views``, ``n_rays``,
``profile_items``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import program, scene
from benchmark.harness.trace import Launches, profiled
from benchmark.reference import plain

COMPARED_STEPS = 3


def _pool(ctx, rig) -> List:
    """``pool`` (source, target) host item pairs; a pose's items are the
    same object where source and target are one pose."""
    cfg, tr = ctx.cfg, ctx.traffic
    n_cam, size = int(cfg["cameras"]), int(cfg["image_size"])
    subject = scene.Subject(rig, n_cam, size)
    inputs = cfg["input_views"]
    n_out, n_rays = int(tr["output_views"]), int(tr["n_rays"])
    ratio = float(cfg["body_ratio"])
    rng = np.random.default_rng([ctx.seed, 3])
    walk = np.random.default_rng(int(cfg["rig_seed"]) + 1)
    pool = []
    for i in range(int(tr["pool"])):
        base = scene.pose_params(walk)
        outputs = sorted(rng.choice(n_cam, n_out, replace=False).tolist())
        if not cfg.get("pair"):
            pool.append((subject.item(base, i, inputs, outputs, n_rays,
                                      ratio, rng),) * 2)
            continue
        # half the pairs a pose with itself, the rest (the first among
        # them, whose steps the check follows) a target pose near it (a
        # few steps of a walk from the source, up to the border)
        if i % 2 == 1:
            item = subject.item(base, 2 * i, inputs, outputs, n_rays, ratio,
                                rng)
            pool.append((item, item))
            continue
        apart = int(rng.integers(1, int(cfg["pair_border"]) + 1))
        tgt = dict(base, poses=(base["poses"] + walk.normal(size=72).astype(
            np.float32) * 0.03 * apart))
        pool.append((subject.item(base, 2 * i, inputs, [], 0, ratio, rng),
                     subject.item(tgt, 2 * i + apart, inputs, outputs,
                                  n_rays, ratio, rng)))
    return pool


def setup(ctx) -> Dict:
    cfg, dev = ctx.cfg, ctx.device
    rig = scene.synthetic_rig(int(cfg["n_verts"]), int(cfg["rig_seed"]))
    pool = _pool(ctx, rig)
    args = program.program_args(cfg)
    model, weights = program.build_model(args, ctx.seed, dev)
    init = {k: v.detach().clone() for k, v in weights.items()}
    del weights

    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.train import trainer as trainer_module

    tcfg = program.train_config(args)
    trainer = trainer_module.Trainer(model, tcfg, device=dev,
                                     seed=ctx.seed % (2 ** 63))
    smpl = program.smpl_model(rig, dev)

    def prepare(pair):
        sp_item, tp_item = pair
        tp = to_device_input(tp_item, dev, rays=True)
        sp = tp if sp_item is tp_item else to_device_input(sp_item, dev)
        return smpl, sp, tp

    # the first steps' inputs and the optimizer's state after steps 1 and 3
    names = {p: n for n, p in model.named_parameters()}
    seen: Dict = {"queries": [], "steps": 0}

    def spy(m, smpl_, sp, tp, latent, ro, rd, z, normals=False, jitter=None):
        if seen["steps"] < COMPARED_STEPS:
            seen["queries"].append((seen["steps"], z.detach().clone(),
                                    None if jitter is None
                                    else jitter.detach().clone()))
        return query_rays(m, smpl_, sp, tp, latent, ro, rd, z, normals,
                          jitter)

    def before_update(opt, *_):
        # the state as the next step finds it: after step 1 the first
        # moment is 0.1 x the first gradient; after the compared steps the
        # parameters are what they made of them
        if seen["steps"] == 1:
            seen["grad"] = {names[p]: s["exp_avg"] / 0.1
                            for p, s in opt.state.items()}
        if seen["steps"] == COMPARED_STEPS:
            seen["params"] = {names[p]: p.detach().clone()
                              for p in trainer.params}

    def after_update(opt, *_):
        seen["steps"] += 1

    query_rays = trainer_module.query_rays
    trainer_module.query_rays = spy
    hooks = [trainer.optimizer.register_step_pre_hook(before_update),
             trainer.optimizer.register_step_post_hook(after_update)]
    try:
        trainer.train_item(*prepare(pool[0]))
        seen["terms"] = [t for t, _ in trainer.last_logs[:COMPARED_STEPS]]
    finally:
        trainer_module.query_rays = query_rays
        for hook in hooks:
            hook.remove()
    trainer.train_item(*prepare(pool[1]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"trainer": trainer, "prepare": prepare, "pool": pool, "rig": rig,
            "init": init, "seen": seen, "args": args, "next": 2,
            "tcfg": tcfg}


class _Mark:
    """A CUDA event on the card; the host clock in the CPU rehearsals."""

    def __init__(self, device):
        self.event = (torch.cuda.Event(enable_timing=True)
                      if device.type == "cuda" else None)

    def record(self):
        if self.event is None:
            self.t = time.perf_counter()
        else:
            self.event.record()

    def elapsed_time(self, end) -> float:
        if self.event is None:
            return 1e3 * (end.t - self.t)
        return self.event.elapsed_time(end.event)


def _items(st):
    pool = st["pool"]
    while True:
        yield pool[st["next"] % len(pool)]
        st["next"] += 1


def window(ctx, st, seconds: float, traced: bool) -> Dict:
    trainer, prepare = st["trainer"], st["prepare"]
    items = _items(st)
    step_ms: Dict[str, List] = {"plain": [], "smooth": []}
    queries: List = []
    restore = []
    if traced:
        # CUDA events around each step and each query's body mask, read
        # after the window
        rays_step, query = trainer.rays_step, trainer.model.query
        events = []

        def timed_step(smpl, sp, tp, rays, smooth, u=None, delta=None):
            a, b = _Mark(ctx.device), _Mark(ctx.device)
            a.record()
            out = rays_step(smpl, sp, tp, rays, smooth, u, delta)
            b.record()
            events.append((smooth, a, b))
            return out

        def counted_query(*a, **k):
            raw = query(*a, **k)
            queries.append((len(events), raw.pts_mask,
                            bool(k.get("compute_normals"))))
            return raw

        trainer.rays_step, trainer.model.query = timed_step, counted_query
        restore = [(trainer, "rays_step"), (trainer.model, "query")]
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        logs = trainer.train_item(*prepare(next(items)))
        steps += len(trainer.last_logs)
        st["dropped"] = max(st.get("dropped", 0.0), logs["n_dropped"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for obj, name in restore:
        delattr(obj, name)
    if traced:
        for smooth, a, b in events:
            step_ms["smooth" if smooth else "plain"].append(a.elapsed_time(b))
    return {"wall_s": wall, "units": steps, "step_ms": step_ms,
            "queries": [(n_step, int(m.sum()), normals)
                        for n_step, m, normals in queries],
            "images": tuple(st["pool"][0][0]["img_all"].shape)}


def profile(ctx, st):
    trainer, prepare = st["trainer"], st["prepare"]
    items = _items(st)
    n = int(ctx.traffic.get("profile_items", 1))
    before = trainer.step
    with Launches() as launches:
        trace = profiled(lambda: [trainer.train_item(*prepare(next(items)))
                                  for _ in range(n)])
    return trace, launches, trainer.step - before


def release(ctx, st):
    st.pop("trainer")
    st.pop("prepare")


def _reference_steps(ctx, st, tf32: bool):
    """The plain reference through the compared steps from the seeded
    weights: (losses, first gradients, parameter changes) by leaf."""
    dev, seen, tcfg = ctx.device, st["seen"], st["tcfg"]
    rig = scene.rig_tensors(st["rig"], dev)
    sp_item, tp_item = st["pool"][0]
    sc = plain.make_scene(rig, scene.item_tensors(sp_item, dev),
                          scene.item_tensors(tp_item, dev))
    match = bool(sp_item["pose_index"] == tp_item["pose_index"]) \
        or not tcfg.pair_mode
    P = dict(st["init"])
    names = plain.leaves(P)
    adam: Dict = {}
    losses, first = [], None
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for step in range(COMPARED_STEPS):
            zs = [(z, j) for s, z, j in seen["queries"] if s == step]

            def ray(key):
                return torch.as_tensor(tp_item[key][step], device=dev)

            # every ray of the view is the reference's: rows the program
            # did not query (counted by the check) take the unjittered
            # ladder and no smooth jitter
            ladder = plain.ladder(ray("near_all")[:, 0], ray("far_all")[:, 0],
                                  zs[0][0].shape[1])
            z = torch.cat([zs[0][0], ladder[zs[0][0].shape[0]:]])
            jitter = None
            if len(zs) > 1:
                jitter = torch.zeros(z.numel(), 3, device=dev)
                jitter[:zs[1][1].shape[0]] = zs[1][1]

            for k in names:
                P[k] = P[k].detach().requires_grad_(True)
            total, _, _ = plain.train_loss(
                P, sc, ray("ray_o_all"), ray("ray_d_all"), z, ray("rgb_all"),
                ray("bkgd_msk_all"), jitter, match)
            grads = torch.autograd.grad(total, [P[k] for k in names],
                                        allow_unused=True)
            g = {k: gk for k, gk in zip(names, grads) if gk is not None}
            losses.append(float(total.detach()))
            if first is None:
                first = {k: v.detach() for k, v in g.items()}
            with torch.no_grad():
                plain.adam_step(P, g, adam, step + 1, plain.lr_at(
                    tcfg.lrate, tcfg.decay_steps, step))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    change = {k: (P[k].detach() - st["init"][k]) for k in names}
    return losses, first, change


def _leaf_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """Each leaf's gap between norms, against the larger of that leaf's
    reference norm and the median leaf's (1 for a leaf the program left
    without a value)."""
    norms = {k: float(torch.linalg.norm(v)) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.norm(got[k])) - n) / max(n, med, 1e-30)
            if k in got else 1.0 for k, n in norms.items()}


def _numbers(losses, first, change, ref, detail=None) -> Dict:
    r_losses, r_first, r_change = ref
    gnorm = {k: float(torch.linalg.norm(v)) for k, v in r_first.items()}
    med = float(np.median(list(gnorm.values())))
    # leaves whose reference gradient is nought to rounding (under a
    # thousandth of the median leaf's) move under Adam by round-off alone
    moved = {k for k, n in gnorm.items() if n >= 1e-3 * med}
    grads = _leaf_gaps(first, r_first)
    steps = _leaf_gaps(change, {k: r_change[k] for k in moved})
    if detail is not None:
        detail.update(
            losses=[list(x) for x in zip(losses, r_losses)],
            grad=sorted(grads.items(), key=lambda kv: -kv[1])[:4],
            step=sorted(steps.items(), key=lambda kv: -kv[1])[:4],
            left_out=sorted(set(gnorm) - moved))
    # the first step's loss: the later ones follow Adam's first updates,
    # whose sign-like steps carry round-off of near-zero gradient elements
    # into the parameters (PERF.md, the check's readings)
    return {
        "loss1_gap": abs(losses[0] - r_losses[0]) / abs(r_losses[0]),
        "grad_gap": max(grads.values()),
        "step_gap": max(steps.values()),
    }


def check(ctx, st):
    seen = st["seen"]
    losses = [float(t.total) for t in seen["terms"]]
    # in-body points the compaction dropped, in the compared steps and the
    # window's
    dropped = max([float(t.n_dropped) for t in seen["terms"]]
                  + [st.get("dropped", 0.0)])
    change = {k: v - st["init"][k]
              for k, v in seen.get("params", {}).items()}
    ref = _reference_steps(ctx, st, tf32=False)
    st["detail"] = {}
    out = _numbers(losses, seen.get("grad", {}), change, ref, st["detail"])
    # the captured depths lie in the strata the rays' near and far give
    tp_item = st["pool"][0][1]
    # (a ray the program did not query counts as its whole row)
    outside = 0
    for step, z, _ in seen["queries"]:
        near = torch.as_tensor(tp_item["near_all"][step][:, 0], device=z.device)
        far = torch.as_tensor(tp_item["far_all"][step][:, 0], device=z.device)
        lo, hi = plain.strata(near, far, z.shape[1])
        r = z.shape[0]
        # a few float32 roundings of the stratum's ends
        tol = 1e-6 * torch.maximum(lo.abs(), hi.abs())[:r]
        outside += int(((z < lo[:r] - tol) | (z > hi[:r] + tol)).sum())
        outside += (near.shape[0] - r) * z.shape[1]
    out.update(n_dropped=dropped, z_outside=float(outside))
    return out


def control(ctx, st):
    """The reference with TF32 products in the program's place."""
    losses, first, change = _reference_steps(ctx, st, tf32=True)
    st["detail"] = {}
    return _numbers(losses, first, change, _reference_steps(ctx, st, False),
                    st["detail"])
