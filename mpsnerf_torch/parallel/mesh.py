"""Multi-device training and rendering over a (data, ray) grid of ranks
(port of ``mpsnerf_tpu/parallel/mesh.py``).

JAX runs one program over a device mesh and combines gradients with
``lax.pmean`` inside ``shard_map``.  Here each rank is a process with one
device, in a ``torch.distributed`` group; a :class:`Mesh` lays the group's
ranks out as a (data, ray) grid (rank = data index x ray size + ray
index) and holds the process groups of its rows (the ``ray`` axis: the
ranks that share an item) and columns (the ``data`` axis).  Loader items
batch over ``data``; an item's rays shard over ``ray`` by stride (ray
index r of k takes rays r, r + k, ...; JAX takes contiguous slices);
parameters, BatchNorm statistics and Adam's state are replicated.

The stride: the loaders put an item's body rays first and a view's rays
come in scan order, so a contiguous slice can hold mostly body rays and
overflow the tail's compaction capacity (half the points) while another
holds mostly background.  Strided shards each take the item's in-body
share.  The step's mean over equal shards and the render's pixels do not
depend on how the rays are split.

A step (:class:`MeshTrainer`, :func:`make_batched_train_step`) runs the
single-device loss unchanged on the rank's item and ray shard, takes the
backward for the parameters, then averages the gradients, the loss terms
and the moved BatchNorm statistics over the mesh with ``all_reduce`` on a
few flattened buckets (``train/trainer.py:pmean_step``) and runs Adam on
every rank: the replicated parameters stay bit-identical, since every
rank applies the same update to the same values.  (``DistributedData
Parallel`` is not used: its reducer does not run under the smooth step's
``create_graph`` double backward, and it would average neither the terms
nor the statistics.)

Device and backend (:func:`initialize_distributed`): a rank takes
``cuda:{local_rank % device_count}`` or the CPU.  NCCL when no two ranks
of this host share a GPU; gloo when they do (NCCL refuses two ranks on
one GPU) and on the CPU.  The rule decides; the choice is printed and
kept in :data:`DIST`.  On device tensors only ``broadcast`` and
``all_reduce`` are used (all that gloo supports for CUDA tensors); items
and other Python objects travel over a CPU gloo group.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from mpsnerf_torch.parallel import collectives
from mpsnerf_torch.parallel.collectives import BUCKET_BYTES, _buckets
from mpsnerf_torch.train.trainer import Trainer

RAY_AXIS = "ray"
DATA_AXIS = "data"
# a collective's wait: long enough for rank 0's eval and checkpoints, which
# run while the other ranks wait for the next batch
DEFAULT_TIMEOUT_S = 3600.0

# this process's placement: rank, world, device, backend and why
DIST: Dict = {}


def pick_backend(device: torch.device, local_world_size: int):
    """``(backend, reason)``: NCCL when each of this host's ranks has a GPU
    of its own, gloo when ranks share one, or on the CPU."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    n_gpu = torch.cuda.device_count()
    if local_world_size > n_gpu:
        return "gloo", (f"{local_world_size} ranks on this host share "
                        f"{n_gpu} GPU{'s' if n_gpu > 1 else ''}")
    return "nccl", f"one GPU for each of this host's {local_world_size} ranks"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda",
                           local_world_size: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S,
                           store=None) -> torch.device:
    """Join a process group (the ``dist.init_process_group('nccl')`` of
    the reference, ``run_nerf_batch.py:26-28``) and return this rank's
    device.  With no ``coordinator`` and no ``store``, from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); else from
    ``coordinator`` (``host:port``, served by process 0) or ``store``, with
    ``num_processes`` and ``process_id``, all on this host unless
    ``local_world_size`` says otherwise.  ``device``: ``"cuda"`` (the
    rank's GPU is ``cuda:{local_rank % device_count}``) or ``"cpu"``."""
    env = coordinator is None and store is None
    if env:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        rank, world = int(process_id), int(num_processes)
        local_world_size = local_world_size or world
        local_rank = rank % local_world_size
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda, but torch sees no CUDA device")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend, reason = pick_backend(dev, local_world_size)
    timeout = datetime.timedelta(seconds=timeout_s)
    if env:
        dist.init_process_group(backend, timeout=timeout)
    elif store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                rank=rank, world_size=world, timeout=timeout)
    DIST.clear()
    DIST.update(rank=rank, world=world, device=str(dev), backend=backend,
                reason=reason, timeout_s=timeout_s)
    print(f"[mesh] rank {rank} of {world} on {dev}: backend {backend} "
          f"({reason})", flush=True)
    return dev


class Mesh:
    """The group's ranks as a (data, ray) grid: rank = d * ray + r.  Every
    rank makes every subgroup, in one order (``new_group`` is
    collective); an axis of size 1 needs none and one spanning the group
    is the default group."""

    def __init__(self, data: int, ray: int, device=None,
                 timeout_s: Optional[float] = None):
        world = dist.get_world_size()
        if data * ray != world:
            raise ValueError(f"mesh (data={data}, ray={ray}) needs "
                             f"{data * ray} ranks; the group has {world}")
        self.shape = {DATA_AXIS: data, RAY_AXIS: ray}
        self.rank = dist.get_rank()
        self.data_index, self.ray_index = divmod(self.rank, ray)
        self.device = torch.device(device or DIST.get("device", "cpu"))
        timeout = datetime.timedelta(
            seconds=timeout_s or DIST.get("timeout_s", DEFAULT_TIMEOUT_S))

        def groups(sets):
            if len(sets[0]) in (1, world):
                return [None] * len(sets)
            return [dist.new_group(s, timeout=timeout) for s in sets]

        rows = groups([[d * ray + r for r in range(ray)] for d in range(data)])
        cols = groups([[d * ray + r for d in range(data)] for r in range(ray)])
        self._groups = {(RAY_AXIS,): (rows[self.data_index], ray),
                        (DATA_AXIS,): (cols[self.ray_index], data),
                        (DATA_AXIS, RAY_AXIS): (None, world)}
        # Python objects (loader items, results) go over the CPU
        self.cpu_group = (None if dist.get_backend() == "gloo" else
                          dist.new_group(backend="gloo", timeout=timeout))

    @property
    def data_size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def ray_size(self) -> int:
        return self.shape[RAY_AXIS]

    def group(self, axis_name):
        """``(process group, size)`` of this rank's peers along an axis
        name or a tuple of names (None: the default group)."""
        names = (axis_name,) if isinstance(axis_name, str) else axis_name
        key = tuple(n for n in (DATA_AXIS, RAY_AXIS) if n in set(names))
        if key not in self._groups or len(key) != len(set(names)):
            raise ValueError(f"axis name {axis_name!r}: the mesh's axes are "
                             f"{DATA_AXIS!r} and {RAY_AXIS!r}")
        return self._groups[key]

    def bound(self):
        """Bind the axis names for the block (see ``collectives``)."""
        return collectives.bind(self)


def make_mesh(axis: str = RAY_AXIS, device=None) -> Mesh:
    """A 1-D mesh over every rank along ``axis``."""
    world = dist.get_world_size()
    return (Mesh(1, world, device) if axis == RAY_AXIS
            else Mesh(world, 1, device))


def make_2d_mesh(data: int, ray: int, device=None) -> Mesh:
    """(data, ray) mesh: items batch over ``data`` (the DataParallel axis,
    ref ``run_nerf_batch.py:350``), rays shard over ``ray`` within each
    item."""
    return Mesh(data, ray, device)


def _broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values into ``tensors`` on every rank, a bucket at a time
    (staged through the mesh's device for NCCL)."""
    for run in _buckets(list(tensors), BUCKET_BYTES):
        flat = torch.cat([t.detach().reshape(-1) for t in run])
        if dist.get_backend() == "nccl":
            flat = flat.to(mesh.device)
        dist.broadcast(flat, src=0)
        offset = 0
        for t in run:
            t.detach().copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def replicate_to_mesh(model: torch.nn.Module, optimizer, mesh: Mesh
                      ) -> None:
    """Make every rank's parameters, buffers and Adam state (with an
    ``optimizer``) rank 0's: a broadcast; the ranks must hold Adam state
    of the same structure."""
    tensors = list(model.parameters()) + list(model.buffers())
    if optimizer is not None:
        keys = [(i, sorted(optimizer.state.get(p, {})))
                for i, p in enumerate(model.parameters())]
        want = [keys]
        dist.broadcast_object_list(want, src=0, group=mesh.cpu_group)
        if want[0] != keys:
            raise RuntimeError("replicate_to_mesh: the ranks' Adam states "
                               "differ in structure")
        tensors += [optimizer.state[p][k] for i, p in
                    enumerate(model.parameters()) for k in keys[i][1]]
    with torch.no_grad():
        _broadcast_(tensors, mesh)


def shard_rays_to_mesh(tensors, mesh: Mesh):
    """This rank's shard, along the leading (ray) dimension, of each tensor
    (a tensor or a tuple of them): every ``ray_size``-th row from its ray
    index on.  The count must divide by the ray axis."""
    one = isinstance(tensors, torch.Tensor)
    out = []
    for t in ((tensors,) if one else tensors):
        n, k = t.shape[0], mesh.ray_size
        if n % k:
            raise ValueError(f"{n} rays do not shard over a ray axis of {k}")
        out.append(t[mesh.ray_index::k])
    return out[0] if one else tuple(out)


def scatter_to_rows(items, mesh: Mesh):
    """Rank 0's list of ``data_size`` Python objects (loader items), one
    to each data row: every rank returns its row's (over the CPU group)."""
    send = None
    if mesh.rank == 0:
        if len(items) != mesh.data_size:
            raise ValueError(f"{len(items)} items for {mesh.data_size} rows")
        send = [items[r // mesh.ray_size]
                for r in range(mesh.data_size * mesh.ray_size)]
    out = [None]
    dist.scatter_object_list(out, send, src=0, group=mesh.cpu_group)
    return out[0]


class MeshTrainer(Trainer):
    """The host loop over a mesh (the DataParallel/DDP replacement, ref
    ``run_nerf_batch.py:344-350``): each rank holds its data row's item;
    one optimizer step per output view, every rank on its strided shard
    of the view's rays, the gradients, terms and BatchNorm
    statistics averaged over ``axis_name`` (both axes) before Adam.
    Smooth every ``smooth_interval``-th step, as :class:`Trainer`.
    Parameters, buffers and Adam state start as rank 0's.  Randomness
    (jitter, smooth delta) comes from the rank's generator, seeded
    ``seed + rank``, or is injected per rank at the shard's shape."""

    def __init__(self, model, cfg, mesh: Mesh, start_step: int = 0,
                 seed: int = 0, axis_name=(DATA_AXIS, RAY_AXIS)):
        super().__init__(model, cfg, device=mesh.device,
                         start_step=start_step, seed=seed + mesh.rank,
                         axis_name=axis_name)
        self.mesh = mesh
        self.data_size, self.ray_size = mesh.data_size, mesh.ray_size
        replicate_to_mesh(self.model, self.optimizer, mesh)

    def rays_step(self, smpl, sp_input, tp_input, rays, smooth, u=None,
                  delta=None):
        """One step on this rank's shard of an item's ``rays`` (every
        rank of a row passes the row item's whole rays)."""
        shard = shard_rays_to_mesh(tuple(rays), self.mesh)
        with self.mesh.bound():
            return super().rays_step(smpl, sp_input, tp_input, shard, smooth,
                                     u, delta)

    def train_items(self, smpl, sp_input, tp_input) -> Dict:
        """One step per view over the mesh's batch of ``data_size`` items,
        this rank holding its row's; returns the averaged scalars under
        ``Trainer.train_item``'s keys (equal on every rank)."""
        return self.train_item(smpl, sp_input, tp_input)

    def load_opt_state(self, opt_state) -> None:
        self.optimizer.load_state_dict(opt_state)
        replicate_to_mesh(self.model, self.optimizer, self.mesh)

    def restore(self, state, load_optimizer: bool = False) -> None:
        super().restore(state, load_optimizer)
        replicate_to_mesh(self.model, self.optimizer, self.mesh)


def _mesh_step(model, cfg, mesh, smooth, axis_name, seed):
    trainer = MeshTrainer(model, cfg, mesh, seed=seed, axis_name=axis_name)

    def step(smpl, sp_input, tp_input, rays_o, rays_d, near, far, target_rgb,
             bkgd_msk, u=None, delta=None):
        return trainer.rays_step(smpl, sp_input, tp_input,
                                 (rays_o, rays_d, near, far, target_rgb,
                                  bkgd_msk), smooth, u, delta)

    step.trainer = trainer
    return step


def make_sharded_train_step(model, cfg, mesh: Mesh, smooth: bool = False,
                            seed: int = 0):
    """The view-step with an item's rays sharded over the ``ray`` axis and
    the mean over it: ``step(smpl, sp, tp, rays_o, rays_d, near, far,
    target_rgb, bkgd_msk, u=None, delta=None) -> (terms, psnr)``, the
    rays the whole item's (each rank takes its slice; ``u`` and ``delta``
    at the shard's shape).  ``step.trainer`` holds the model and Adam."""
    return _mesh_step(model, cfg, mesh, smooth, RAY_AXIS, seed)


def make_batched_train_step(model, cfg, mesh: Mesh, smooth: bool = False,
                            seed: int = 0):
    """The item-batched view-step over a (data, ray) mesh: each rank passes
    its data row's item; the mean over both axes (one gradient of the
    item-mean loss).  Signature as :func:`make_sharded_train_step`."""
    return _mesh_step(model, cfg, mesh, smooth, (DATA_AXIS, RAY_AXIS), seed)


def make_sharded_render(model, mesh: Mesh, n_samples: int, chunk: int = 0,
                        white_bkgd: bool = False, capacity: int = 0,
                        tile: int = 16384):
    """Rays sharded over the ``ray`` axis: each rank renders its strided
    shard with no traffic, then the shards are gathered into the whole
    image on every rank.  Returns ``fn(smpl, sp, tp, latent, rays_o,
    rays_d, near, far) -> (rgb, disp, acc, n_dropped)`` on the whole rays
    (perturb 0), ``n_dropped`` holding each rank's compaction drop (0:
    every shard was exact; the JAX render drops it).  ``chunk`` > 0
    renders a slice longer than it in chunks (``render_rays_mapped``, a
    rank's drop the largest of its chunks'); ``capacity`` > 0 renders it
    with global compaction (``render_rays_compact``, ``capacity``
    candidates per rank, a multiple of ``tile``).

    The gather: each rank writes its shard into a zero-filled buffer of the
    whole outputs and one ``all_reduce`` sums the buffers.  A sum with
    zeros is exact, and gloo supports no ``all_gather`` of CUDA tensors;
    the cost is the ray axis's size times the image's bytes (5 floats a
    pixel)."""
    from mpsnerf_torch.renderer.render import (
        render_rays, render_rays_compact, render_rays_mapped,
    )

    def fn(smpl, sp_input, tp_input, latent, rays_o, rays_d, near, far):
        n = rays_o.shape[0]
        ro, rd, nr, fr = shard_rays_to_mesh((rays_o, rays_d, near, far), mesh)
        if capacity > 0:
            rgb, disp, acc, dropped = render_rays_compact(
                model, smpl, sp_input, tp_input, latent, ro, rd, nr, fr,
                n_samples, capacity=capacity, tile=tile,
                white_bkgd=white_bkgd)
        elif chunk and ro.shape[0] > chunk:
            rgb, disp, acc, dropped = render_rays_mapped(
                model, smpl, sp_input, tp_input, latent, ro, rd, nr, fr,
                chunk=chunk, n_samples=n_samples, with_dropped=True,
                white_bkgd=white_bkgd)
        else:
            out = render_rays(model, smpl, sp_input, tp_input, latent, ro, rd,
                              nr, fr, n_samples, white_bkgd=white_bkgd)
            rgb, disp, acc = out.rgb_map, out.disp_map, out.acc_map
            dropped = out.raw.n_dropped
        # the whole (rgb, disp, acc) and the ranks' n_dropped in one buffer
        k = mesh.ray_size
        buf = torch.zeros(n * 5 + k, dtype=rgb.dtype, device=rgb.device)
        full = buf[:n * 5].view(n, 5)
        part = full[mesh.ray_index::k]
        part[:, :3] = rgb
        part[:, 3] = disp
        part[:, 4] = acc
        buf[n * 5 + mesh.ray_index] = torch.as_tensor(dropped).to(rgb.dtype)
        if k > 1:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                            group=mesh.group(RAY_AXIS)[0])
        return full[:, :3], full[:, 3], full[:, 4], buf[n * 5:]

    return fn
