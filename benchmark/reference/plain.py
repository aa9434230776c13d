"""The plain reference of MPS-NeRF (arXiv:2203.16875) that decides whether
a run of the port is correct.

Plain PyTorch over a flat dict ``P`` of parameters (named as the port's
``state_dict``, so one seeded dict feeds both sides), written from the
model's equations: the SMPL rig's kinematics and linear blend skinning,
the exact 5 cm body mask by brute-force nearest vertex, the pixel-aligned
features (the first stages of ResNet-34 and a bilinear lookup with border
replication, written as four gathers so that autograd gives its first and
second derivatives), the view-fusion transformer, the NeRF MLP, volume
compositing, the training losses and Adam.  Every sample of a ray is
evaluated: there is no body grid, no compaction, no bucket table and no
kernel.  It imports nothing of the port and of JAX.

Two arithmetic choices follow the port's on purpose, since a threshold
compares what they produce: world -> SMPL coordinates are formed as
``(x0 * R0 + x1 * R1) + x2 * R2`` and squared distances as
``(dx * dx + dy * dy) + dz * dz``, the lowest vertex id winning a tie.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

HUMAN_DIST_SQ = 0.05 ** 2  # the 5 cm body mask
MASK_FILL = -80.0          # raw rgb and density of a sample off the body
BIG_POSE = ((5, math.pi / 4), (8, -math.pi / 4), (23, -math.pi / 6),
            (26, math.pi / 6))
N_JOINTS = 24


# ---- the SMPL rig ----------------------------------------------------------

def big_pose(device) -> torch.Tensor:
    v = torch.zeros(72, dtype=torch.float32, device=device)
    for i, a in BIG_POSE:
        v[i] = a
    return v


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle -> (N, 3, 3); 1e-8 added before the norm."""
    angle = torch.linalg.norm(r + 1e-8, dim=-1, keepdim=True)
    ax = r / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    z = torch.zeros_like(ax[:, 0])
    k = torch.stack([z, -ax[:, 2], ax[:, 1], ax[:, 2], z, -ax[:, 0],
                     -ax[:, 1], ax[:, 0], z], -1).reshape(-1, 3, 3)
    return torch.eye(3, device=r.device) + sin * k + (1 - cos) * (k @ k)


def joint_transforms(rig: Dict, poses: torch.Tensor, shapes: torch.Tensor):
    """The 24 joints' rigid transforms (24, 4, 4) of a pose and shape."""
    v = rig["v_template"] + torch.einsum("vds,s->vd", rig["shapedirs"],
                                         shapes.reshape(-1))
    joints = rig["J_regressor"] @ v
    rot = rodrigues(poses.reshape(-1, 3))
    parents = rig["parents"]
    chain = []
    for j in range(N_JOINTS):
        t = joints[j] - (joints[parents[j]] if j else 0.0)
        local = torch.eye(4, device=v.device)
        local = torch.cat([torch.cat([rot[j], t[:, None]], 1), local[3:]], 0)
        chain.append(local if j == 0 else chain[parents[j]] @ local)
    a = torch.stack(chain)
    shift = torch.einsum("jab,jb->ja", a[:, :3, :3], joints)
    last = a[:, :3, 3] - shift
    return torch.cat([torch.cat([a[:, :3, :3], last[:, :, None]], 2),
                      a[:, 3:]], 1)


def pose_offsets(rig: Dict, poses: torch.Tensor) -> torch.Tensor:
    rot = rodrigues(poses.reshape(-1, 3))
    feat = (rot[1:] - torch.eye(3, device=rot.device)).reshape(-1)
    nv = rig["v_template"].shape[0]
    return (rig["posedirs"].reshape(nv * 3, -1) @ feat).reshape(nv, 3)


def to_smpl(p: torch.Tensor, R: torch.Tensor, Th: torch.Tensor):
    """World -> SMPL frame: ``(p - Th) @ R``."""
    d, R = p - Th.reshape(1, 3), R.reshape(3, 3)
    return (d[:, 0:1] * R[0] + d[:, 1:2] * R[1]) + d[:, 2:3] * R[2]


def inv3(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverses by the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca, cb, cc = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * ca + b * cb + c * cc
    adj = torch.stack([ca, -(b * i - c * h), b * f - c * e,
                       cb, a * i - c * g, -(a * f - c * d),
                       cc, -(a * h - b * g), a * e - b * d], -1)
    return adj.reshape(m.shape) / det[..., None, None]


def to_world(p: torch.Tensor, R: torch.Tensor, Th: torch.Tensor):
    Ri = inv3(R.reshape(3, 3))
    return (p[:, 0:1] * Ri[0] + p[:, 1:2] * Ri[1]) + p[:, 2:3] * Ri[2] \
        + Th.reshape(1, 3)


def posed_vertices(rig: Dict, params: Dict) -> torch.Tensor:
    """The template posed by ``params`` (poses, shapes, R, Th), world."""
    a = joint_transforms(rig, params["poses"], params["shapes"])
    v = (rig["v_template"] + torch.einsum("vds,s->vd", rig["shapedirs"],
                                          params["shapes"].reshape(-1))
         + pose_offsets(rig, params["poses"]))
    ap = (rig["weights"] @ a.reshape(24, 16)).reshape(-1, 4, 4)
    v = torch.einsum("nij,nj->ni", ap[:, :3, :3], v) + ap[:, :3, 3]
    return to_world(v, params["R"], params["Th"])


def nearest(q: torch.Tensor, v: torch.Tensor, block: int = 2048):
    """Exact 1-NN by brute force: (d2 (N,), ids (N,)), the lowest id on a
    tie."""
    d2s, ids = [], []
    ar = torch.arange(v.shape[0], device=v.device)
    for s in range(0, q.shape[0], block):
        diff = q[s:s + block, None, :] - v[None]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        best = d2.amin(1)
        hit = torch.where(d2 == best[:, None], ar, v.shape[0])
        d2s.append(best)
        ids.append(hit.amin(1))
    if not d2s:
        return q.new_zeros(0), torch.zeros(0, dtype=torch.int64,
                                           device=q.device)
    return torch.cat(d2s), torch.cat(ids)


def vertex_normals(v: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    def unit(x):
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                               min=1e-8)

    t = v[faces]
    fn = unit(torch.linalg.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]))
    vn = torch.zeros_like(v)
    for k in range(3):
        vn.index_add_(0, faces[:, k], fn)
    return unit(vn)


class Pose(NamedTuple):
    A: torch.Tensor
    A_big: torch.Tensor
    R: torch.Tensor
    Th: torch.Tensor


def pose_of(rig: Dict, params: Dict) -> Pose:
    return Pose(joint_transforms(rig, params["poses"], params["shapes"]),
                joint_transforms(rig, big_pose(rig["weights"].device),
                                 params["shapes"]),
                params["R"].reshape(3, 3), params["Th"].reshape(3))


def _blend(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return (w @ a.reshape(24, 16)).reshape(-1, 4, 4)


def _mv(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nij,nj->ni", m, x)


# ---- the network -------------------------------------------------------------

def linear(P: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    b = P.get(name + ".bias")
    return F.linear(x, P[name + ".weight"], b)


def pe(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(f0 x), cos(f0 x), sin(f1 x), ...], f_k = pi 2^k."""
    out = [x]
    for k in range(n_freqs):
        f = math.pi * 2.0 ** k
        out += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(out, -1)


def batchnorm(P: Dict, name: str, x: torch.Tensor, train: bool):
    """flax BatchNorm: biased batch variance in training, the running
    statistics otherwise (eps 1e-5)."""
    if train:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    mul = torch.rsqrt(var + 1e-5) * P[name + ".weight"]
    return (x - mean[:, None, None]) * mul[:, None, None] \
        + P[name + ".bias"][:, None, None]


def encode(P: Dict, images: torch.Tensor, train: bool,
           blocks: int = 3) -> torch.Tensor:
    """ResNet-34's stem and first stage on a 2x2-averaged image:
    (V, 3, H, W) -> (V, 128, H/4, W/4)."""
    pre = "encoder_2d.model."
    x = F.avg_pool2d(images, 2)
    x = F.relu(batchnorm(P, pre + "bn1",
                         F.conv2d(x, P[pre + "conv1.weight"], None, 2, 3),
                         train))
    y = x
    for b in range(blocks):
        n = f"{pre}layer1.{b}."
        h = F.relu(batchnorm(P, n + "bn1", F.conv2d(
            y, P[n + "conv1.weight"], None, 1, 1), train))
        h = batchnorm(P, n + "bn2", F.conv2d(h, P[n + "conv2.weight"], None,
                                             1, 1), train)
        y = F.relu(h + y)
    return torch.cat([x, y], 1)


def bilinear(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``image`` (V, C, H, W) at coords (V, N, 2) in [-1, 1], corners
    aligned, border replicated: four gathers at clamped corners weighted
    by the unclamped position.  Returns (V, N, C)."""
    v, c, h, w = image.shape
    ix = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    iy = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    ax, bx = x0 + 1.0 - ix, ix - x0
    ay, by = y0 + 1.0 - iy, iy - y0
    xi = [torch.clamp(x0, 0, w - 1).long(), torch.clamp(x0 + 1, 0, w - 1).long()]
    yi = [torch.clamp(y0, 0, h - 1).long(), torch.clamp(y0 + 1, 0, h - 1).long()]
    flat = image.reshape(v, c, h * w)
    out = 0.0
    for yy, wy in ((yi[0], ay), (yi[1], by)):
        for xx, wx in ((xi[0], ax), (xi[1], bx)):
            idx = (yy * w + xx)[:, None, :].expand(-1, c, -1)
            out = out + torch.gather(flat, 2, idx) * (wx * wy)[:, None, :]
    return out.permute(0, 2, 1)


def transformer(P: Dict, x: torch.Tensor, depth: int = 2, heads: int = 4,
                dim_head: int = 64) -> torch.Tensor:
    """Pre-norm transformer over the view axis of (V, N, D)."""
    for i in range(depth):
        a = f"transformer.layers.{i}.0.fn."
        y = F.layer_norm(x, x.shape[-1:], P[a + "norm.weight"],
                         P[a + "norm.bias"], 1e-5)
        q, k, v = F.linear(y, P[a + "fn.to_qkv.weight"]).chunk(3, -1)
        nv, n = x.shape[:2]
        q, k, v = (t.reshape(nv, n, heads, dim_head) for t in (q, k, v))
        att = torch.softmax(torch.einsum("inhd,jnhd->nhij", q, k)
                            * dim_head ** -0.5, -1)
        o = torch.einsum("nhij,jnhd->inhd", att, v).reshape(nv, n, -1)
        x = x + linear(P, a + "fn.to_out.0", o)
        f = f"transformer.layers.{i}.1.fn."
        y = F.layer_norm(x, x.shape[-1:], P[f + "norm.weight"],
                         P[f + "norm.bias"], 1e-5)
        y = F.gelu(linear(P, f + "fn.net.0", y))
        x = x + linear(P, f + "fn.net.3", y)
    return x


def nerf_mlp(P: Dict, can: torch.Tensor, f1, f2, depth: int = 8,
             skips=(4,)):
    x = torch.cat([pe(can, 6), f1], -1)
    h = x
    for i in range(depth):
        h = F.relu(linear(P, f"pts_linears.{i}", h))
        if i in skips:
            h = torch.cat([x, h], -1)
    alpha = linear(P, "alpha_linear", h)[:, 0]
    h = torch.cat([linear(P, "feature_linear", h), f2], -1)
    rgb = linear(P, "rgb_linear", F.relu(linear(P, "views_linear", h)))
    return rgb, alpha


class Scene(NamedTuple):
    """One (source, target) pair on the device: the rig, both poses, the
    source views and the target's posed and the canonical vertices."""

    rig: Dict
    src: Pose
    tgt: Pose
    images: torch.Tensor      # (V, 3, H, W)
    K: torch.Tensor           # (V, 3, 3)
    R: torch.Tensor           # (V, 3, 3)
    T: torch.Tensor           # (V, 3, 1)
    tgt_smpl_verts: torch.Tensor
    can_verts: torch.Tensor
    can_normals: torch.Tensor


def make_scene(rig: Dict, sp: Dict, tp: Dict) -> Scene:
    """``sp``/``tp``: the source and target items' tensors (params,
    vertices, t_vertices, img_all, K_all, R_all, T_all)."""
    tgt = pose_of(rig, tp["params"])
    can = sp["t_vertices"]
    return Scene(rig, pose_of(rig, sp["params"]), tgt, sp["img_all"],
                 sp["K_all"], sp["R_all"], sp["T_all"],
                 to_smpl(tp["vertices"], tgt.R, tgt.Th), can,
                 vertex_normals(can, rig["faces"]))


class Raw(NamedTuple):
    rgb: torch.Tensor        # (N, 3) pre-activation, MASK_FILL off the body
    sigma: torch.Tensor      # (N,)
    mask: torch.Tensor       # (N,) float 1 on the body
    normal: Optional[torch.Tensor]       # (N, 3) masked occupancy normal
    smpl_normal: Optional[torch.Tensor]  # (N, 3) masked nearest normal


def body_mask(sc: Scene, world: torch.Tensor):
    """The 5 cm mask and the target's nearest vertex of world points; the
    box of the vertices 5 cm out rules most points out first."""
    q = to_smpl(world, sc.tgt.R, sc.tgt.Th)
    lo = sc.tgt_smpl_verts.amin(0) - 0.05
    hi = sc.tgt_smpl_verts.amax(0) + 0.05
    near = ((q >= lo) & (q <= hi)).all(-1).nonzero()[:, 0]
    d2, ids = nearest(q[near], sc.tgt_smpl_verts)
    keep = d2 < HUMAN_DIST_SQ
    return q, near[keep], ids[keep]


def query(P: Dict, sc: Scene, latent: torch.Tensor, world: torch.Tensor,
          normals: bool = False) -> Raw:
    """Raw outputs at world points (N, 3) of the target pose."""
    n = world.shape[0]
    q, idx, ids = body_mask(sc, world)
    rig = sc.rig
    # target -> canonical (inverse skinning at the nearest posed vertex)
    w = rig["weights"][ids]
    a = _blend(w, sc.tgt.A)
    can = _mv(inv3(a[:, :3, :3]), q[idx] - a[:, :3, 3])
    ab = _blend(w, sc.tgt.A_big)
    can = _mv(ab[:, :3, :3], can) + ab[:, :3, 3]

    def tail(c):
        _, idc = nearest(c.detach(), sc.can_verts)
        wc = rig["weights"][idc]
        ab = _blend(wc, sc.src.A_big)
        p = _mv(inv3(ab[:, :3, :3]), c - ab[:, :3, 3])
        a_s = _blend(wc, sc.src.A)
        src = _mv(a_s[:, :3, :3], p) + a_s[:, :3, 3]
        wp = to_world(src, sc.src.R, sc.src.Th)
        cam = torch.einsum("vij,nj->vni", sc.R, wp) + sc.T.reshape(-1, 1, 3)
        pix = torch.einsum("vij,vnj->vni", sc.K, cam)
        uv = pix[..., :2] / (pix[..., 2:] + 1e-5)
        size = torch.tensor([sc.images.shape[-1], sc.images.shape[-2]],
                            dtype=uv.dtype, device=uv.device)
        crd = 2.0 * uv / size - 1.0
        feats = torch.cat([bilinear(latent, crd),
                           pe(bilinear(sc.images, crd), 4)], -1)
        fused = transformer(P, feats)
        rgb, alpha = nerf_mlp(P, c, fused[0], fused[1])
        return rgb, alpha, idc

    normal = smpl_normal = None
    if normals:
        with torch.enable_grad():
            can = can.detach().requires_grad_(True)
            rgb, alpha, idc = tail(can)
            s = torch.sigmoid(alpha)
            (g,) = torch.autograd.grad(alpha, can, (1 + 2e-4) * s * (1 - s),
                                       create_graph=True)
        n2 = (g * g).sum(-1, keepdim=True)
        ok = (n2 > 1e-8).detach()
        g = torch.where(ok, g / torch.sqrt(torch.where(ok, n2,
                                                       torch.ones_like(n2))),
                        torch.zeros_like(g))
        normal = world.new_zeros(n, 3).index_put((idx,), g)
        smpl_normal = world.new_zeros(n, 3).index_put(
            (idx,), sc.can_normals[idc])
    else:
        rgb, alpha, _ = tail(can)
    mask = world.new_zeros(n).index_put((idx,), torch.ones_like(alpha))
    return Raw(world.new_full((n, 3), MASK_FILL).index_put((idx,), rgb),
               world.new_full((n,), MASK_FILL).index_put((idx,), alpha),
               mask, normal, smpl_normal)


# ---- rays, compositing, losses, Adam -----------------------------------------

def ladder(near: torch.Tensor, far: torch.Tensor, n: int) -> torch.Tensor:
    """The stratified depths (R, n) before jitter; t = i * (1 / (n - 1))
    with the last exactly 1."""
    t = torch.cat([torch.arange(n - 1, dtype=torch.float32,
                                device=near.device)
                   * torch.tensor(1.0 / (n - 1), device=near.device),
                   torch.ones(1, device=near.device)])
    return near[:, None] * (1.0 - t) + far[:, None] * t


def strata(near: torch.Tensor, far: torch.Tensor, n: int):
    """The bins ``(lower, upper)`` (R, n) of stratified sampling."""
    z = ladder(near, far, n)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    return torch.cat([z[:, :1], mids], 1), torch.cat([mids, z[:, -1:]], 1)


def composite(raw_rgb, raw_sigma, z, rays_d):
    """Volume rendering of (R, S, 3) / (R, S): (rgb (R, 3), acc (R,))."""
    rgb = (1 + 2e-4) * torch.sigmoid(raw_rgb) - 1e-4
    d = z[:, 1:] - z[:, :-1]
    d = torch.cat([d, torch.full_like(d[:, :1], 1e10)], -1)
    d = d * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-F.softplus(raw_sigma - 1.0) * d)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    wgt = alpha * trans
    return (wgt[..., None] * rgb).sum(1), wgt.sum(1)


def render_rays(P: Dict, sc: Scene, latent, ro, rd, near, far,
                n_samples: int, block: int = 1024) -> torch.Tensor:
    """Eval render of rays (R, 3) at the unjittered ladder: (R, 3)."""
    out = []
    for s in range(0, ro.shape[0], block):
        o, d = ro[s:s + block], rd[s:s + block]
        z = ladder(near[s:s + block], far[s:s + block], n_samples)
        pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
        raw = query(P, sc, latent, pts)
        r = o.shape[0]
        out.append(composite(raw.rgb.reshape(r, -1, 3),
                             raw.sigma.reshape(r, -1), z, d)[0])
    return torch.cat(out) if out else ro.new_zeros(0, 3)


def train_loss(P: Dict, sc: Scene, ro, rd, z, target, bkgd,
               delta: Optional[torch.Tensor], pose_match: bool = True):
    """The view-step loss at depths ``z`` (R, S) (jittered by the step);
    ``delta`` (R * S, 3) adds the smooth terms.  Returns the total and
    the terms (img, acc, normal_smooth, smpl_normal)."""
    latent = encode(P, sc.images, train=True)
    r, s = z.shape
    pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
    smooth = delta is not None
    raw = query(P, sc, latent, pts, normals=smooth)
    rgb, acc = composite(raw.rgb.reshape(r, s, 3), raw.sigma.reshape(r, s),
                         z, rd)
    img = torch.mean((rgb - target) ** 2)
    if not pose_match:
        img = img * 0.0
    acc_l = torch.mean((bkgd.reshape(acc.shape) - acc) ** 2)
    total = img + acc_l
    ns = sn = torch.zeros((), device=z.device)
    if smooth:
        pert = query(P, sc, latent, pts + delta, normals=True)
        ns = torch.mean((pert.normal - raw.normal) ** 2)
        sn = torch.mean((raw.smpl_normal + raw.normal) ** 2)
        total = total + 0.1 * ns + 0.1 * sn
    return total, (img, acc_l, ns, sn), raw.mask


def adam_step(P: Dict, grads: Dict, state: Dict, t: int, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam update of the leaves in ``grads`` (step ``t`` from 1)."""
    for k, g in grads.items():
        m, v = state.setdefault(k, (torch.zeros_like(g), torch.zeros_like(g)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[k] = (m, v)
        step = lr / (1 - b1 ** t)
        P[k] = P[k] - step * m / (torch.sqrt(v) / math.sqrt(1 - b2 ** t)
                                  + eps)


def lr_at(lrate: float, decay_steps: int, step: int) -> float:
    return lrate * 0.5 ** (step / decay_steps)


def leaves(P: Dict) -> List[str]:
    """The trained leaves (every float tensor but BatchNorm's running
    statistics)."""
    return [k for k, v in P.items() if v.is_floating_point()
            and not k.endswith(("running_mean", "running_var"))]
