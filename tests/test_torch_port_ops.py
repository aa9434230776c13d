"""Parity of the PyTorch port's ops (``mpsnerf_torch.ops``) with the JAX
package's, on the CPU: the same seeded numpy inputs go through both.

On the CPU the kernel wrappers (the 1-NN, the packed 1-NN and the patch
grid-sample's forward, backward and double backward) take their plain
versions; the CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsnerf_tpu.ops import body_grid as j_body_grid
from mpsnerf_tpu.ops import compact as j_compact
from mpsnerf_tpu.ops import composite as j_composite
from mpsnerf_tpu.ops import grid_sample as j_grid_sample
from mpsnerf_tpu.ops import knn as j_knn
from mpsnerf_tpu.ops import positional as j_positional
from mpsnerf_tpu.smpl import lbs as j_lbs
from mpsnerf_tpu.smpl import mesh as j_mesh
from mpsnerf_tpu.smpl.model import synthetic_smpl as j_synthetic_smpl

from mpsnerf_torch.ops import body_grid as t_body_grid
from mpsnerf_torch.ops import compact as t_compact
from mpsnerf_torch.ops import composite as t_composite
from mpsnerf_torch.ops import grid_sample as t_grid_sample
from mpsnerf_torch.ops import knn as t_knn
from mpsnerf_torch.ops import positional as t_positional
from mpsnerf_torch.smpl import lbs as t_lbs
from mpsnerf_torch.smpl import mesh as t_mesh
from mpsnerf_torch.smpl.model import synthetic_smpl as t_synthetic_smpl
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _brute(q, v, block=512):
    d2s, ids = [], []
    for s in range(0, len(q), block):
        d = ((q[s:s + block, None, :] - v[None, :, :]) ** 2).sum(-1)
        d2s.append(d.min(1))
        ids.append(d.argmin(1))
    return np.concatenate(d2s), np.concatenate(ids)


def _check_knn(ids, d2, q, v, atol=1e-4):
    """The criterion of tests/test_ops.py:TestKNN._check: argmin ties can
    flip on fp noise, so the chosen vertex's distance and the returned
    distance must equal the true minimum, and >= 95 % of ids must match."""
    bd, bi = _brute(q, v)
    ids = np.asarray(ids)
    chosen = ((q - v[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(chosen, bd, atol=atol)
    np.testing.assert_allclose(np.asarray(d2), bd, atol=atol)
    assert (ids == bi).mean() > 0.95


@pytest.fixture(scope="module")
def rig():
    """The full 6890-vertex synthetic rig in both packages, with a pose."""
    rng = np.random.default_rng(0)
    params = {
        "poses": (rng.normal(size=72) * 0.2).astype(np.float32),
        "shapes": (rng.normal(size=10) * 0.3).astype(np.float32),
        "R": np.eye(3, dtype=np.float32),
        "Th": np.asarray([[0.1, -0.2, 0.3]], np.float32),
    }
    j_smpl = j_synthetic_smpl(n_verts=6890, seed=0)
    t_smpl = t_synthetic_smpl(n_verts=6890, seed=0, device="cpu")
    return j_smpl, t_smpl, params


def test_port_imports_without_jax_flax_cv2_or_jax_package():
    """Every module of the port (training, the probe tool and the mesh
    module included) imports with jax, flax, optax, orbax, cv2 and the JAX
    package made unimportable (the card's machine has none of them)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'cv2', 'mpsnerf_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, mpsnerf_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    mpsnerf_torch.__path__, 'mpsnerf_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "need = {'mpsnerf_torch.train.trainer', 'mpsnerf_torch.train.losses',\n"
        "        'mpsnerf_torch.train.checkpoint', 'mpsnerf_torch.smpl.mesh',\n"
        "        'mpsnerf_torch.tools.knn_variant_probe',\n"
        "        'mpsnerf_torch.serve.sharded',\n"
        "        'mpsnerf_torch.tools.validate_dataset',\n"
        "        'mpsnerf_torch.tools.train_proof',\n"
        "        'mpsnerf_torch.tools.generalization_proof',\n"
        "        'mpsnerf_torch.tools.pair_train_proof'}\n"
        "assert need <= set(names) and len(names) >= 76, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


class TestNearestVertex:
    def test_plain_matches_xla_full_rig(self, rig):
        """4096 queries against the 6890-vertex rig: the plain version
        against nearest_vertex_xla and brute force."""
        j_smpl, _, _ = rig
        v = np.asarray(j_smpl.v_template)
        rng = np.random.default_rng(3)
        q = (v[rng.integers(0, len(v), 4096)]
             + rng.normal(size=(4096, 3)) * 0.05).astype(np.float32)
        d2_t, ids_t = t_knn.nearest_vertex(_t(q), _t(v))
        d2_j, ids_j = j_knn.nearest_vertex_xla(jnp.asarray(q), jnp.asarray(v))
        _check_knn(ids_t.numpy(), d2_t.numpy(), q, v)
        _check_knn(np.asarray(ids_j), np.asarray(d2_j), q, v)
        # the XLA oracle is the |q|^2 - 2q.v + |v|^2 form: its d2 carries
        # ~1e-6 cancellation error, and near-ties may pick another id
        np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=1e-4)
        assert (ids_t.numpy() == np.asarray(ids_j)).mean() > 0.95
        assert ids_t.dtype == torch.int64

    @pytest.mark.parametrize("nq,nv,seed", [(600, 300, 1), (777, 250, 0)])
    def test_plain_matches_pallas_interpret(self, nq, nv, seed):
        """Against the TPU kernel run in interpret mode, at the sizes of
        tests/test_ops.py (1e-3: the packed key truncates d2's low bits)."""
        rng = np.random.default_rng(seed)
        q = rng.normal(size=(nq, 3)).astype(np.float32)
        v = rng.normal(size=(nv, 3)).astype(np.float32)
        d2_t, ids_t = t_knn.nearest_vertex(_t(q), _t(v))
        d2_p, ids_p = j_knn.nearest_vertex_pallas(
            jnp.asarray(q), jnp.asarray(v), interpret=True)
        _check_knn(ids_t.numpy(), d2_t.numpy(), q, v)
        _check_knn(np.asarray(ids_p), np.asarray(d2_p), q, v, atol=1e-3)
        assert (ids_t.numpy() == np.asarray(ids_p)).mean() > 0.95

    def test_plain_is_diff_form_lowest_index_on_ties(self):
        """d2 is exactly (dx*dx + dy*dy) + dz*dz at the returned id, the
        id is the lowest of tied vertices, and blocking changes nothing."""
        v = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0], [0, 0, 2.0]])
        q = torch.tensor([[0.0, 0, 0], [2.0, 0, 0], [0, 0, 1.9]])
        d2, ids = t_knn.nearest_vertex_plain(q, v, block_elems=4)
        assert ids.tolist() == [0, 0, 3]
        diff = q - v[ids]
        exact = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
            + diff[:, 2] * diff[:, 2]
        assert torch.equal(d2, exact)
        d2b, idsb = t_knn.nearest_vertex_plain(q, v)
        assert torch.equal(d2, d2b) and torch.equal(ids, idsb)

    def test_cpu_tensors_never_count_a_launch(self, rig):
        _, t_smpl, _ = rig
        before = t_knn.LAUNCHES["nearest_vertex"]
        t_knn.nearest_vertex(t_smpl.v_template[:100].contiguous(),
                             t_smpl.v_template)
        assert t_knn.LAUNCHES["nearest_vertex"] == before == 0

    @pytest.mark.parametrize("case", ["cpu", "dtype", "shape"])
    def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(self, case):
        """The kernel wrapper raises (it never falls back) on a CPU tensor,
        a non-float32 tensor or a non-(n, 3) shape."""
        q = torch.zeros(8, 3)
        v = torch.ones(5, 3)
        if case == "dtype":
            q = q.double()
        elif case == "shape":
            q = torch.zeros(8, 4)
        with pytest.raises((ValueError, TypeError)):
            t_knn.nearest_vertex_cuda(q, v)
        assert t_knn.LAUNCHES["nearest_vertex"] == 0


def _culling_case(kind, nv, seed=0, nq=1500):
    """Query and vertex sets built to break K1's skip rule (float32)."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(nv, 3)) * 0.3).astype(np.float32)
    near = v[rng.integers(0, nv, nq)] + rng.normal(size=(nq, 3)) * 0.05
    if kind == "ties":
        # a lattice of step 1/8 with shuffled ids; queries at cell centres
        # and edge midpoints tie exactly between vertices of other buckets
        m = int(np.ceil(nv ** (1 / 3))) + 1
        grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1)
        v = (grid.reshape(-1, 3)[:nv] / 8.0)[rng.permutation(nv)]
        cell = v[rng.integers(0, nv, nq)]
        half = rng.integers(0, 2, (nq, 3)) / 16.0
        half[: nq // 2] = 1 / 16.0
        q = cell + half
    elif kind == "duplicates":
        base = v[: max(1, (nv + 1) // 2)]
        v = np.concatenate([base, base[: nv - len(base)]])[rng.permutation(nv)]
        q = v[rng.integers(0, nv, nq)] + rng.normal(size=(nq, 3)) * 0.02
        q[: nq // 4] = v[rng.integers(0, nv, nq // 4)]  # on a vertex
    elif kind == "box_faces":
        b = t_knn.build_vertex_buckets(_t(v))
        lo, hi = b.boxes[:, 0:3].numpy(), b.boxes[:, 4:7].numpy()
        pick = rng.integers(0, 2, (len(lo), 8, 3)).astype(bool)
        corners = np.where(pick, lo[:, None], hi[:, None]).reshape(-1, 3)
        faces = np.repeat((lo + hi) / 2, 6, 0).reshape(len(lo), 6, 3)
        for a in range(3):
            faces[:, 2 * a, a], faces[:, 2 * a + 1, a] = lo[:, a], hi[:, a]
        q = np.concatenate([corners, faces.reshape(-1, 3)])
        q = q[rng.permutation(len(q))[:nq]]
    elif kind == "far":
        d = rng.normal(size=(nq, 3))
        q = d / np.linalg.norm(d, axis=1, keepdims=True) * 1e3
        q[:64] *= 1e17  # d2 overflows to inf: every vertex ties
    elif kind == "random_order":
        q = near[rng.permutation(nq)]
    else:  # "rays": samples along lines through the table, in ray order
        rays = []
        for c in v[rng.integers(0, nv, nq // 50)]:
            d = rng.normal(size=3)
            rays.append(c + np.linspace(-0.4, 0.4, 50)[:, None] * d
                        / np.linalg.norm(d))
        q = np.concatenate(rays)
    return np.ascontiguousarray(q, np.float32), np.ascontiguousarray(
        v, np.float32)


class TestBucketedNearestVertex:
    """K1's culled search (``nearest_vertex_bucketed_plain``: the kernel's
    buckets, groups of 32, bounds and skip rule in plain PyTorch) equals
    the brute force id for id and d2 for d2."""

    @pytest.mark.parametrize("nv", [1, 31, 33, 6890])
    @pytest.mark.parametrize("kind", ["ties", "duplicates", "box_faces",
                                      "far", "random_order", "rays"])
    def test_culled_search_equals_brute_force(self, kind, nv):
        q, v = map(_t, _culling_case(kind, nv))
        b = t_knn.build_vertex_buckets(v)
        d2, ids, pairs = t_knn.nearest_vertex_bucketed_plain(q, b)
        d2_p, ids_p = t_knn.nearest_vertex_plain(q, v)
        assert torch.equal(ids, ids_p) and torch.equal(d2, d2_p)
        assert ids.dtype == torch.int64
        nb = b.boxes.shape[0]
        assert len(q) * t_knn.BUCKET <= pairs <= len(q) * nb * t_knn.BUCKET
        if kind == "ties" and nv > 1:
            ties = (_t(q)[:, None, :] - v[None]).pow(2).sum(-1)
            assert int((ties == ties.min(1, keepdim=True).values).sum()) \
                > 2 * len(q)  # the set really ties

    def test_culling_skips_most_pairs_on_ray_ordered_queries(self, rig):
        """On the 6890-vertex rig the ray-ordered queries evaluate a small
        share of the brute force's pairs, and the result is unchanged."""
        _, t_smpl, _ = rig
        v = t_smpl.v_template.float().contiguous()
        rng = np.random.default_rng(5)
        rays = []
        for c in v.numpy()[rng.integers(0, len(v), 40)]:
            d = rng.normal(size=3)
            rays.append(c + np.linspace(-0.4, 0.4, 64)[:, None] * d
                        / np.linalg.norm(d))
        q = _t(np.concatenate(rays).astype(np.float32))
        b = t_knn.build_vertex_buckets(v)
        d2, ids, pairs = t_knn.nearest_vertex_bucketed_plain(q, b)
        d2_p, ids_p = t_knn.nearest_vertex_plain(q, v)
        assert torch.equal(ids, ids_p) and torch.equal(d2, d2_p)
        assert pairs < 0.3 * len(q) * len(v)

    def test_culled_search_matches_jax(self, rig):
        """Against the JAX package's ``nearest_vertex`` on the rig, with
        TestNearestVertex's criterion (the JAX CPU oracle is the product
        form)."""
        j_smpl, _, _ = rig
        v = np.asarray(j_smpl.v_template)
        rng = np.random.default_rng(4)
        q = (v[rng.integers(0, len(v), 2048)]
             + rng.normal(size=(2048, 3)) * 0.05).astype(np.float32)
        d2, ids, _ = t_knn.nearest_vertex_bucketed_plain(
            _t(q), t_knn.build_vertex_buckets(_t(v)))
        d2_j, ids_j = j_knn.nearest_vertex(jnp.asarray(q), jnp.asarray(v))
        _check_knn(ids.numpy(), d2.numpy(), q, v)
        np.testing.assert_allclose(d2.numpy(), np.asarray(d2_j), atol=1e-4)
        assert (ids.numpy() == np.asarray(ids_j)).mean() > 0.95

    @pytest.mark.parametrize("nv", [1, 31, 33, 6890])
    def test_bucket_build_against_brute_force_boxes(self, nv, rig):
        """Every vertex in exactly one place (the pad repeats the last),
        rows equal to the vertex of their id, ids ascending in a bucket,
        each box the min/max of its rows; on the rig the Morton order keeps
        buckets small (by id they would span the body)."""
        v = (rig[1].v_template.float() if nv == 6890 else _t(
            np.random.default_rng(nv).normal(size=(nv, 3)).astype(
                np.float32)))
        b = t_knn.build_vertex_buckets(v)
        nb = -(-nv // t_knn.BUCKET)
        assert b.n_verts == nv and b.table.shape == (nb * t_knn.BUCKET, 4)
        assert b.boxes.shape == (nb, 8)
        ids = b.table[:, 3].contiguous().view(torch.int32).long()
        assert sorted(set(ids.tolist())) == list(range(nv))
        assert len(ids) - len(set(ids.tolist())) == nb * t_knn.BUCKET - nv
        assert torch.equal(b.table[:, :3], v[ids])
        rows = b.table[:, :3].numpy().reshape(nb, t_knn.BUCKET, 3)
        for k in range(nb):
            bucket_ids = ids[k * t_knn.BUCKET:(k + 1) * t_knn.BUCKET]
            assert bool((bucket_ids[1:] >= bucket_ids[:-1]).all())
            np.testing.assert_array_equal(b.boxes[k, 0:3].numpy(),
                                          rows[k].min(0))
            np.testing.assert_array_equal(b.boxes[k, 4:7].numpy(),
                                          rows[k].max(0))
        assert float(b.boxes[:, 3].abs().sum() + b.boxes[:, 7].abs().sum()) \
            == 0.0
        if nv == 6890:
            diag = (b.boxes[:, 4:7] - b.boxes[:, 0:3]).norm(dim=1).mean()
            whole = (v.amax(0) - v.amin(0)).norm()
            assert float(diag) < 0.25 * float(whole)

    @pytest.mark.parametrize("case", ["cpu", "shape"])
    def test_cuda_bucket_build_rejects_what_it_does_not_take(self, case):
        """The build kernel's wrapper raises on a CPU table or a non-(V, 3)
        one (it never falls back); the CPU dispatch counts no launch."""
        v = torch.zeros(8, 3) if case == "cpu" else torch.zeros(8, 4)
        with pytest.raises(ValueError):
            t_knn.build_vertex_buckets_cuda(v)
        t_knn.build_vertex_buckets(torch.zeros(8, 3))
        assert t_knn.LAUNCHES["vertex_buckets"] == 0

    def test_cpu_dispatch_ignores_buckets(self, rig):
        """On the CPU ``nearest_vertex`` is the brute force whether or not
        buckets are passed, and counts no launch."""
        _, t_smpl, _ = rig
        v = t_smpl.v_template.float()
        q = v[:300] + 0.01
        b = t_knn.build_vertex_buckets(v)
        a, c = t_knn.nearest_vertex(q, v, b), t_knn.nearest_vertex_plain(q, v)
        assert all(torch.equal(x, y) for x, y in zip(a, c))
        assert t_knn.LAUNCHES["nearest_vertex"] == 0

    def test_cpu_table_gets_no_buckets(self, rig, monkeypatch):
        """``kernel_buckets`` builds nothing for a CPU table (the brute
        force reads none), and ``nearest_vertex`` builds none itself."""
        def no_build(verts):
            raise AssertionError("buckets built for a CPU table")

        monkeypatch.setattr(t_knn, "build_vertex_buckets_plain", no_build)
        v = rig[1].v_template.float()
        assert t_knn.kernel_buckets(v) is None
        a = t_knn.nearest_vertex(v[:300] + 0.01, v)
        assert torch.equal(a[1], t_knn.nearest_vertex_plain(v[:300] + 0.01,
                                                            v)[1])


class TestCompaction:
    @pytest.mark.parametrize("capacity", [1024, 2048, 6144])
    def test_plan_resize_and_expand_scatter_exact(self, capacity):
        """Integer plans equal JAX's exactly, with and without drops;
        expand_scatter is pure data movement, so floats are equal too."""
        rng = np.random.default_rng(capacity)
        n = 5000
        mask = (rng.uniform(size=n) < 0.3).astype(np.int32)
        jp = j_compact.plan_compaction(jnp.asarray(mask), capacity)
        tp = t_compact.plan_compaction(_t(mask), capacity)
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        small = capacity // 2
        jr = j_compact.resize_plan(jp, small)
        tr = t_compact.resize_plan(tp, small)
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        buf = rng.normal(size=(small, 4)).astype(np.float32)
        je = j_compact.expand_scatter(jr, jnp.asarray(buf), -80.0)
        te = t_compact.expand_scatter(tr, _t(buf), -80.0)
        np.testing.assert_array_equal(np.asarray(je), te.numpy())
        tg = t_compact.expand_gather(tr, _t(buf), -80.0)
        np.testing.assert_array_equal(np.asarray(je), tg.numpy())
        x = rng.normal(size=(n, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(j_compact.compact(jr, jnp.asarray(x))),
            t_compact.compact(tr, _t(x)).numpy())


def test_body_grid_and_lookup_exact(rig):
    """The host grid is the same array, and the candidate masks are equal
    (exact: the same float32 floor of the same values)."""
    j_smpl, _, _ = rig
    v = np.asarray(j_smpl.v_template)
    jg = j_body_grid.build_body_grid(v)
    tg = t_body_grid.build_body_grid(v)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(5)
    q = np.concatenate([
        v[rng.integers(0, len(v), 3000)] + rng.normal(size=(3000, 3)) * 0.08,
        rng.uniform(-3, 3, size=(1000, 3)),
    ]).astype(np.float32)
    jm = np.asarray(j_body_grid.grid_lookup(jg, jnp.asarray(q)))
    tm = t_body_grid.grid_lookup(tg, _t(q)).numpy()
    np.testing.assert_array_equal(jm, tm)
    assert 0.2 < tm.mean() < 0.9


def test_grid_sample_patch_and_index_features(rig):
    """atol 1e-6: the same bilinear weights and corner reads in fp32; only
    the summation can round differently (values are O(1))."""
    rng = np.random.default_rng(6)
    img = rng.normal(size=(3, 8, 17, 13)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, size=(3, 200, 2)).astype(np.float32)
    j = j_grid_sample.grid_sample_2d_patch(jnp.asarray(img), jnp.asarray(coords))
    t = t_grid_sample.grid_sample_2d_patch(_t(img), _t(coords))
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-6)
    uv = rng.uniform(-5, 70, size=(3, 200, 2)).astype(np.float32)
    j = j_grid_sample.index_features_patch(jnp.asarray(img), jnp.asarray(uv),
                                           (64.0, 68.0))
    t = t_grid_sample.index_features_patch(_t(img), _t(uv), (64.0, 68.0))
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-6)


@pytest.mark.parametrize("num_freqs", [4, 6])
def test_positional_encoding(num_freqs):
    """atol 1e-5: sin/cos of the same fp32 arguments from two libms."""
    rng = np.random.default_rng(num_freqs)
    x = rng.uniform(-1.5, 1.5, size=(500, 3)).astype(np.float32)
    j = j_positional.positional_encoding(jnp.asarray(x), num_freqs)
    t = t_positional.positional_encoding(_t(x), num_freqs)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-5)


@pytest.mark.parametrize("white_bkgd,occupancy",
                         [(False, False), (True, False), (False, True)])
def test_composite_rays_and_z_vals(white_bkgd, occupancy):
    """The depth ladder is bit-identical (jnp.linspace's rounding);
    compositing agrees to 1e-5 (exp / cumprod / sums in fp32)."""
    rng = np.random.default_rng(7)
    r, s = 64, 32
    near = rng.uniform(1.0, 1.5, size=(r, 1)).astype(np.float32)
    far = near + rng.uniform(0.5, 1.0, size=(r, 1)).astype(np.float32)
    zj = j_composite.stratified_z_vals(None, jnp.asarray(near),
                                       jnp.asarray(far), s, 0.0)
    zt = t_composite.stratified_z_vals(_t(near), _t(far), s)
    np.testing.assert_array_equal(np.asarray(zj), zt.numpy())
    raw_rgb = rng.normal(size=(r, s, 3)).astype(np.float32) * 3
    raw_sigma = rng.normal(size=(r, s)).astype(np.float32) * 5
    raw_sigma[:8] = -80.0
    rays_d = rng.normal(size=(r, 3)).astype(np.float32)
    j = j_composite.composite_rays(jnp.asarray(raw_rgb), jnp.asarray(raw_sigma),
                                   zj, jnp.asarray(rays_d),
                                   occupancy=occupancy, white_bkgd=white_bkgd)
    t = t_composite.composite_rays(_t(raw_rgb), _t(raw_sigma), zt, _t(rays_d),
                                   occupancy=occupancy, white_bkgd=white_bkgd)
    for name in ("rgb_map", "acc_map", "weights", "depth_map"):
        np.testing.assert_allclose(np.asarray(getattr(j, name)),
                                   getattr(t, name).numpy(), atol=1e-5,
                                   err_msg=name)


def test_stratified_jitter_uses_injected_noise():
    """perturb > 0 takes the caller's uniform noise: u = 0 gives each
    bin's lower edge, u = 1 its upper edge."""
    near = torch.full((2, 1), 1.0)
    far = torch.full((2, 1), 2.0)
    z = t_composite.stratified_z_vals(near, far, 5)
    lo = t_composite.stratified_z_vals(near, far, 5, 1.0, torch.zeros(2, 5))
    hi = t_composite.stratified_z_vals(near, far, 5, 1.0, torch.ones(2, 5))
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    assert torch.equal(lo[:, 1:], mids) and torch.equal(lo[:, 0], z[:, 0])
    assert torch.equal(hi[:, :-1], mids) and torch.equal(hi[:, -1], z[:, -1])
    with pytest.raises(ValueError):
        t_composite.stratified_z_vals(near, far, 5, 1.0)


@pytest.mark.parametrize("mean_shape", [False, True])
def test_lbs_warps(rig, mean_shape):
    """Pose transforms and both warps at atol 1e-5 (fp32 products of
    O(1) transforms, summed in another order)."""
    j_smpl, t_smpl, params = rig
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: _t(v) for k, v in params.items()}
    jtf = j_lbs.PoseTransforms.create(j_smpl, jparams)
    ttf = t_lbs.PoseTransforms.create(t_smpl, tparams)
    for name in ("A", "A_big", "joints", "pose_offsets", "shape_offsets"):
        np.testing.assert_allclose(np.asarray(getattr(jtf, name)),
                                   getattr(ttf, name).numpy(), atol=1e-5,
                                   err_msg=name)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 6890, 1000).astype(np.int32)
    pts = (np.asarray(j_smpl.v_template)[ids]
           + rng.normal(size=(1000, 3)) * 0.03).astype(np.float32)
    j_can = j_lbs.deform_target_to_canonical(
        j_smpl, jtf, jnp.asarray(pts), jnp.asarray(ids), mean_shape)
    t_can = t_lbs.deform_target_to_canonical(
        t_smpl, ttf, _t(pts), _t(ids).long(), mean_shape)
    np.testing.assert_allclose(np.asarray(j_can), t_can.numpy(), atol=1e-5)
    j_out = j_lbs.deform_canonical_to_source(
        j_smpl, jtf, j_can, jnp.asarray(ids), None, mean_shape)
    t_out = t_lbs.deform_canonical_to_source(
        t_smpl, ttf, t_can, _t(ids).long(), mean_shape)
    for a, b in zip(j_out, t_out):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(j_lbs.posed_vertices(j_smpl, jparams)),
        t_lbs.posed_vertices(t_smpl, tparams).numpy(), atol=1e-5)


def test_rodrigues_and_rigid_transforms():
    """Kinematics at atol 1e-6 (a zero axis-angle maps to the identity)."""
    from mpsnerf_tpu.smpl import kinematics as j_kin
    from mpsnerf_torch.smpl import kinematics as t_kin

    rng = np.random.default_rng(9)
    r = (rng.normal(size=(24, 3)) * 0.5).astype(np.float32)
    r[3] = 0.0
    jr = j_kin.rodrigues(jnp.asarray(r))
    tr = t_kin.rodrigues(_t(r))
    np.testing.assert_allclose(np.asarray(jr), tr.numpy(), atol=1e-6)
    np.testing.assert_allclose(tr[3].numpy(), np.eye(3), atol=1e-6)
    joints = rng.normal(size=(24, 3)).astype(np.float32)
    parents = j_synthetic_smpl(n_verts=100, seed=0).parents
    ja = j_kin.rigid_transforms(jr, jnp.asarray(joints), np.asarray(parents))
    ta = t_kin.rigid_transforms(tr, _t(joints), parents)
    np.testing.assert_allclose(np.asarray(ja), ta.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(j_kin.big_pose_vector()),
                                  t_kin.big_pose_vector().numpy())


# ---- K2: the patch grid-sample, its backward and its double backward ----

def _k2_case(seed, v=2, c=5, h=9, w=11, n=300):
    """A third of the coords outside [-1, 1] in x or in y, a sixth on pixel
    positions (the borders included), the rest inside."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(v, c, h, w)).astype(np.float32)
    crd = rng.uniform(-1, 1, size=(v, n, 2)).astype(np.float32)
    k, m = n // 3, n // 6
    idx = np.arange(k)
    crd[:, idx, idx % 2] = (np.sign(crd[:, idx, idx % 2])
                            * rng.uniform(1.01, 1.4, size=(v, k)))
    crd[:, k:k + m, 0] = rng.integers(0, w, (v, m)) / (w - 1) * 2 - 1
    crd[:, k:k + m, 1] = rng.integers(0, h, (v, m)) / (h - 1) * 2 - 1
    crd[:, k, :] = 1.0
    crd[:, k + 1, :] = -1.0
    others = [rng.normal(size=sh).astype(np.float32)
              for sh in ((v, c, n), img.shape, crd.shape)]
    return (img, crd, *others)


def _k2_jax(img, crd, g, gg_i, gg_c, which):
    if which == "fwd":
        return [j_grid_sample.grid_sample_2d_patch(img, crd)]
    if which == "bwd":
        _, vjp = jax.vjp(j_grid_sample.grid_sample_2d_patch, img, crd)
        return list(vjp(g))

    def f(img, crd, g):
        _, vjp = jax.vjp(j_grid_sample.grid_sample_2d_patch, img, crd)
        d_img, d_crd = vjp(g)
        return jnp.sum(d_img * gg_i) + jnp.sum(d_crd * gg_c)

    return list(jax.grad(f, argnums=(0, 1, 2))(img, crd, g))


def _k2_torch(img, crd, g, gg_i, gg_c, which):
    ti = torch.tensor(img, requires_grad=True)
    tc = torch.tensor(crd, requires_grad=True)
    tg = torch.tensor(g, requires_grad=True)
    out = t_grid_sample.grid_sample_2d_patch(ti, tc)
    if which == "fwd":
        return [out]
    d_img, d_crd = torch.autograd.grad(out, (ti, tc), tg, create_graph=True)
    if which == "bwd":
        return [d_img, d_crd]
    s = (d_img * torch.tensor(gg_i)).sum() + (d_crd * torch.tensor(gg_c)).sum()
    return list(torch.autograd.grad(s, (ti, tc, tg)))


@pytest.mark.parametrize("which", ["fwd", "bwd", "bwd2"])
def test_grid_sample_patch_matches_jax(which):
    """K2's forward (the patch form), backward (the 4-corner VJP, the JAX
    custom_vjp's) and double backward (JAX's autodiff of that VJP) on the
    plain path, with coords inside, outside and on pixel positions:
    atol 1e-5 of each output's max |value| (at least 1): the coordinate
    outputs carry (W-1)/2 and (H-1)/2 factors and sum over channels in
    another order."""
    case = _k2_case(0)
    j = _k2_jax(*map(jnp.asarray, case), which)
    t = _k2_torch(*case, which)
    assert len(j) == len(t) == {"fwd": 1, "bwd": 2, "bwd2": 3}[which]
    for a, b in zip(j, t):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(a).max()))


def test_grid_sample_patch_coordinate_gradient_at_the_border():
    """Beyond the border in one axis the coordinate gradient equals JAX's
    and is not zero (its component along the border); on the far border
    (x = W-1) it equals JAX's zero along x, where autograd through the
    patch form's clamped weight gives the backward difference instead."""
    rng = np.random.default_rng(1)
    img = rng.normal(size=(1, 4, 5, 6)).astype(np.float32)
    crd = np.array([[[1.3, 0.1], [-1.2, 0.33], [0.2, 1.25], [1.0, 0.1],
                     [-1.0, 0.1]]], np.float32)
    g = np.ones((1, 4, 5), np.float32)
    _, vjp = jax.vjp(j_grid_sample.grid_sample_2d_patch, jnp.asarray(img),
                     jnp.asarray(crd))
    want = np.asarray(vjp(jnp.asarray(g))[1])[0]
    tc = torch.tensor(crd, requires_grad=True)
    t_grid_sample.grid_sample_2d_patch(torch.tensor(img), tc).sum().backward()
    got = tc.grad.numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (np.abs(got[:3]).sum(-1) > 1e-3).all()  # beyond the border
    assert got[3, 0] == 0.0
    tp = torch.tensor(crd, requires_grad=True)
    t_grid_sample.grid_sample_2d_patch_plain(torch.tensor(img), tp).sum() \
        .backward()
    assert abs(tp.grad.numpy()[0, 3, 0]) > 1e-3


def test_grid_sample_patch_gradcheck_and_gradgradcheck():
    """float64 finite differences on the plain path: the backward inside
    the image (where the patch and 4-corner forms have one derivative),
    and the double backward everywhere away from integer positions."""
    rng = np.random.default_rng(2)
    img = torch.tensor(rng.normal(size=(2, 3, 6, 7)), requires_grad=True)
    inside = torch.tensor(rng.uniform(-0.9, 0.9, (2, 20, 2)),
                          requires_grad=True)
    wide = torch.tensor(rng.uniform(-1.3, 1.3, (2, 20, 2)),
                        requires_grad=True)
    f = t_grid_sample.grid_sample_2d_patch
    assert torch.autograd.gradcheck(f, (img, inside))
    assert torch.autograd.gradgradcheck(f, (img, wide))


def test_grid_sample_patch_skips_the_image_scatter(monkeypatch):
    """An image that carries no gradient (the RGB inputs) gets no scatter:
    the backward is asked for the coordinate gradient only; coords that
    carry none (the latent's in the plain train step) get no coordinate
    gradient, and the image gradient still equals JAX's."""
    seen = []
    plain = t_grid_sample.grid_sample_patch_backward_plain

    def spy(g, image, coords, need_image, need_coords):
        seen.append((need_image, need_coords))
        out = plain(g, image, coords, need_image, need_coords)
        assert (out[0] is None) != need_image
        assert (out[1] is None) != need_coords
        return out

    monkeypatch.setattr(t_grid_sample, "grid_sample_patch_backward_plain", spy)
    img, crd, g, *_ = _k2_case(3)
    tc = torch.tensor(crd, requires_grad=True)
    t_grid_sample.grid_sample_2d_patch(torch.tensor(img), tc).sum().backward()
    ti = torch.tensor(img, requires_grad=True)
    t_grid_sample.grid_sample_2d_patch(ti, torch.tensor(crd)).backward(
        torch.tensor(g))
    assert seen == [(False, True), (True, False)] and tc.grad is not None
    _, vjp = jax.vjp(j_grid_sample.grid_sample_2d_patch, jnp.asarray(img),
                     jnp.asarray(crd))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(ti.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_grid_sample_patch_inner_gradient_skips_the_image_scatter(
        monkeypatch):
    """The occupancy normal's inner ``autograd.grad`` is taken for the
    points only: the latent's scatter is skipped there (the engine would
    drop it), and the outer gradients through the double backward are the
    same as when it is computed."""
    img, crd, g, *_ = _k2_case(6)

    def run():
        seen = []
        plain = t_grid_sample.grid_sample_patch_backward_plain

        def spy(g_, image, coords, need_image, need_coords):
            seen.append((need_image, need_coords))
            return plain(g_, image, coords, need_image, need_coords)

        monkeypatch.setattr(t_grid_sample,
                            "grid_sample_patch_backward_plain", spy)
        leaf = torch.tensor(img, requires_grad=True)
        latent = leaf * 1.0  # a non-leaf, as the encoder's output is
        tc = torch.tensor(crd, requires_grad=True)
        out = t_grid_sample.grid_sample_2d_patch(latent, tc)
        (normal,) = torch.autograd.grad(out, tc, torch.tensor(g),
                                        create_graph=True)
        ((out ** 2).sum() + (normal ** 2).sum()).backward()
        monkeypatch.undo()
        return seen, leaf.grad, tc.grad

    seen, d_img, d_crd = run()
    assert seen == [(False, True), (True, True)]
    monkeypatch.setattr(t_grid_sample, "_grad_reaches",
                        lambda ctx, i: ctx.needs_input_grad[i])
    seen_all, d_img_all, d_crd_all = run()
    assert seen_all == [(True, True), (True, True)]
    torch.testing.assert_close(d_img, d_img_all, rtol=0, atol=0)
    torch.testing.assert_close(d_crd, d_crd_all, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["fwd", "bwd", "bwd2"])
def test_grid_sample_patch_plain_versions_on_a_channels_last_image(which):
    """The plain versions give the same values on a channels-last image
    (the encoder's latent) as on a contiguous one, exactly."""
    img, crd, g, gg_i, gg_c = map(_t, _k2_case(7, c=8))
    last = img.contiguous(memory_format=torch.channels_last)
    gg_last = gg_i.contiguous(memory_format=torch.channels_last)
    assert last.stride(1) == 1 and torch.equal(last, img)
    for a, b in zip(_k2_plain(img, crd, g, gg_i, gg_c, which),
                    _k2_plain(last, crd, g, gg_last, gg_c, which)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _k2_plain(img, crd, g, gg_i, gg_c, which):
    if which == "fwd":
        return [t_grid_sample.grid_sample_2d_patch_plain(img, crd)]
    if which == "bwd":
        return list(t_grid_sample.grid_sample_patch_backward_plain(
            g, img, crd, True, True))
    return list(t_grid_sample.grid_sample_patch_double_backward_plain(
        g, img, crd, gg_i, gg_c, (True, True, True)))


def test_layout_copies_only_for_wide_images_with_spread_channels():
    """The wrappers' layout rule, on the CPU (nothing is launched): a
    channels-last latent and a (V, 3, H, W) RGB are read as they lie; only
    a wide image whose channels are not innermost is copied, and counted."""
    copies = t_grid_sample.LAYOUT_COPIES
    before = copies["grid_sample_patch"]
    latent = torch.zeros(2, 8, 5, 6).contiguous(
        memory_format=torch.channels_last)
    rgb = torch.zeros(2, 3, 5, 6)
    assert t_grid_sample._channels_last(latent) is latent
    assert t_grid_sample._channels_last(rgb) is rgb
    assert copies["grid_sample_patch"] == before
    spread = t_grid_sample._channels_last(torch.zeros(2, 8, 5, 6))
    assert spread.stride(1) == 1 and copies["grid_sample_patch"] == before + 1
    copies["grid_sample_patch"] = before


def test_grid_sample_4_corner_form_matches_jax():
    """``grid_sample_2d`` (the 4-corner form the backward is built on) at
    atol 1e-6."""
    img, crd, *_ = _k2_case(4)
    np.testing.assert_allclose(
        np.asarray(j_grid_sample.grid_sample_2d(jnp.asarray(img),
                                                jnp.asarray(crd))),
        t_grid_sample.grid_sample_2d(_t(img), _t(crd)).numpy(), atol=1e-6)


@pytest.mark.parametrize("which", ["fwd", "bwd", "bwd2"])
def test_grid_sample_cuda_wrappers_reject_cpu_tensors(which):
    """A kernel wrapper never falls back: CPU tensors raise there, and the
    dispatching function's CPU path counts no launch."""
    img, crd, g, gg_i, gg_c = map(_t, _k2_case(5))
    with pytest.raises(ValueError):
        if which == "fwd":
            t_grid_sample.grid_sample_patch_fwd_cuda(img, crd)
        elif which == "bwd":
            t_grid_sample.grid_sample_patch_bwd_cuda(g, img, crd, True,
                                                     True)
        else:
            t_grid_sample.grid_sample_patch_bwd2_cuda(
                g, img, crd, gg_i, gg_c, (True, True, True))
    _k2_torch(*_k2_case(5), "bwd2")
    assert all(n == 0 for n in t_grid_sample.LAUNCHES.values())


# ---- the packed-key 1-NN (the probe's kernel_vT / _nn_kernel function) ----

@pytest.mark.parametrize("nq,nv,seed", [(3000, 700, 0), (2048, 1500, 1)])
def test_packed_plain_matches_pallas_interpret(nq, nv, seed):
    """The packed plain version against the TPU kernel in interpret mode:
    >= 99.9 % of ids equal, and every other id in the same 13-bit
    truncation class of d^2 (the two d^2 within 2^-10 relative); the
    returned d^2 is the exact diff form at the id."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.2, 1.2, size=(nq, 3)).astype(np.float32)
    v = rng.uniform(-1.0, 1.0, size=(nv, 3)).astype(np.float32)
    d2_t, ids_t = t_knn.nearest_vertex_packed(_t(q), _t(v))
    _, ids_p = j_knn.nearest_vertex_pallas(jnp.asarray(q), jnp.asarray(v),
                                           interpret=True)
    ids_t, ids_p = ids_t.numpy(), np.asarray(ids_p)
    assert (ids_t == ids_p).mean() >= 0.999
    da = ((q - v[ids_t]) ** 2).sum(-1)
    db = ((q - v[ids_p]) ** 2).sum(-1)
    assert (np.abs(da - db) <= 2.0 ** -10 * np.maximum(da, db)).all()
    diff = _t(q) - _t(v)[torch.from_numpy(ids_t)]
    assert torch.equal(d2_t, t_knn._d2(diff))


def test_packed_plain_key_semantics():
    """One integer min over (bits(d^2) & ~0x1FFF) | id: d^2 within one
    truncation class tie, and the lowest id wins among them, where the
    exact 1-NN takes the nearer vertex."""
    v = torch.tensor([[1.0001, 0, 0], [0, 2.0, 0], [1.0, 0, 0], [0, 0, 3.0]])
    q = torch.tensor([[0.0, 0, 0], [0, 0, 2.9]])
    d2, ids = t_knn.nearest_vertex_packed_plain(q, v)
    assert ids.tolist() == [0, 3]  # 1.0002 and 1.0 share a class
    assert d2[0] == t_knn._d2(q[:1] - v[:1])[0]
    _, exact = t_knn.nearest_vertex_plain(q, v)
    assert exact.tolist() == [2, 3]
    _, ids_far = t_knn.nearest_vertex_packed_plain(q, v * 1.01)
    assert ids_far.tolist() == [0, 3]


def test_packed_raises_where_jax_raises():
    """Padded to the 1152-vertex tile the count must fit 13 bits: 8064
    vertices pass, 8065 raise, in both packages."""
    q = np.zeros((4, 3), np.float32)
    ok = np.random.default_rng(0).normal(size=(8064, 3)).astype(np.float32)
    too_many = np.concatenate([ok, ok[:1]])
    assert t_knn.nearest_vertex_packed(_t(q), _t(ok))[1].shape == (4,)
    for f in (lambda: t_knn.nearest_vertex_packed(_t(q), _t(too_many)),
              lambda: j_knn.nearest_vertex_pallas(
                  jnp.asarray(q), jnp.asarray(too_many), interpret=True)):
        with pytest.raises(ValueError):
            f()
    with pytest.raises(ValueError):
        t_knn.nearest_vertex_packed_cuda(_t(q), _t(ok))
    assert t_knn.LAUNCHES["nearest_vertex_packed"] == 0


def test_vertex_normals(rig):
    """Vertex normals of the posed rig at atol 1e-6 (cross products and
    normalisations in fp32, summed by index_add_ in another order)."""
    j_smpl, t_smpl, params = rig
    verts = np.asarray(j_lbs.posed_vertices(
        j_smpl, {k: jnp.asarray(v) for k, v in params.items()}))
    j = np.asarray(j_mesh.vertex_normals(jnp.asarray(verts), j_smpl.faces))
    t = t_mesh.vertex_normals(_t(verts), t_smpl.faces).numpy()
    np.testing.assert_allclose(j, t, atol=1e-6)
    norms = np.linalg.norm(t, axis=-1)  # 0: a vertex in no face
    assert (np.abs(norms - 1.0) < 1e-5).mean() > 0.8
    assert ((np.abs(norms - 1.0) < 1e-5) | (norms == 0)).all()
