"""The port's training CLI on a mesh, on CPU gloo ranks
(``run_nerf_batch_torch.py --mesh_devices 4 --batch_size 2``), at
``tests/test_cli_mesh.py``'s sizes on ``configs/synthetic_smoke.txt``:
each of 4 ranks runs the CLI in the group the launch made
(``tests/torch_mesh_workers.py:cli_rank``, as under torchrun); rank 0
alone writes checkpoints and scalars; the two ranks of a data row train
on the same item and rays (a checksum of the item each rank receives);
the items come in the single-process CLI's order (its first two items,
its loader's next two); no shard drops a point.  The CLI started alone
spawns its ranks and fails when one of them does; the flags keep JAX's
divisibility rule; a failing rank fails the launch."""

import json
import os
import sys

import numpy as np
import pytest

import run_nerf_batch_torch
from mpsnerf_torch.data.prefetch import PrefetchLoader
from mpsnerf_torch.factory import return_dataset
from mpsnerf_torch.parallel.launch import RankFailed, Ranks, spawn
from tests.torch_mesh_workers import cli_rank, fail_on_rank, item_checksum
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

COMMON = ["--config", "configs/synthetic_smoke.txt", "--image_scaling",
          "0.0625", "--N_rand", "32", "--N_samples", "8", "--i_print", "4",
          "--i_testset", "1000000", "--num_worker", "0", "--device", "cpu"]


def test_mesh_cli_rows_share_items_in_the_single_process_order(
        tmp_path, monkeypatch):
    started = Ranks(cli_rank, 4, (COMMON + [
        "--basedir", str(tmp_path / "mesh"), "--expname", "m",
        "--mesh_devices", "4", "--batch_size", "2", "--N_iteration", "6",
        "--i_weights", "6"],), timeout_s=300, threads=1)

    # meanwhile, the single-process CLI's first two items (they make the
    # first batch; its loader's next two the second)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    single_items = []
    draw = PrefetchLoader.__next__

    def draw_spy(self):
        item = draw(self)
        single_items.append(item_checksum(item))
        return item

    monkeypatch.setattr(PrefetchLoader, "__next__", draw_spy)
    single = run_nerf_batch_torch.main(COMMON + [
        "--basedir", str(tmp_path / "single"), "--expname", "s",
        "--N_iteration", "11", "--i_weights", "1000"])
    assert len(single_items) == 2
    loader = PrefetchLoader(return_dataset(single.args),
                            seed=single.args.seed, num_workers=0)
    stream = single_items + [item_checksum(draw(loader))
                             for _ in range(4)][2:]

    ranks = started.wait(300)
    assert [(r["rank"], r["data_index"], r["ray_index"]) for r in ranks] == \
        [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    # 2 batch steps of 6 view-steps (an item's 6 output views)
    assert all(r["global_step"] == 12 and len(r["items"]) == 2
               for r in ranks)
    ckpts = tmp_path / "mesh" / "m" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["000006", "000012"]
    assert ranks[0]["saved"] == [str(ckpts / "000006"),
                                 str(ckpts / "000012")]
    assert all(r["saved"] == [] for r in ranks[1:])
    rows = [json.loads(x) for x in (tmp_path / "mesh" / "summaries" / "m" /
                                    "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [6, 12]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["psnr"])
               for r in rows)
    # the terms are averaged over the mesh: every rank logs the same; the
    # strided ray shards each hold their item's in-body share
    assert all(r["logs"] == ranks[0]["logs"] for r in ranks)
    assert all(lg["n_dropped"] == 0 for lg in ranks[0]["logs"])
    # a row's ranks saw one item and its rays; the rows saw two, in the
    # single-process order
    assert ranks[0]["items"] == ranks[1]["items"]
    assert ranks[2]["items"] == ranks[3]["items"]
    assert stream == [ranks[0]["items"][0], ranks[2]["items"][0],
                      ranks[0]["items"][1], ranks[2]["items"][1]]
    assert len(set(stream)) == 4


def test_mesh_cli_spawns_its_ranks_and_fails_with_one(tmp_path):
    """The CLI with no group starts its 2 ranks; rank 0 fails loading the
    data (no THuman tree at ``--data_root``) while rank 1 waits for its
    weights: the CLI raises with rank 0's traceback."""
    with pytest.raises(RankFailed, match="rank 0 failed"):
        run_nerf_batch_torch.main(COMMON + [
            "--basedir", str(tmp_path), "--expname", "f",
            "--data_set_type", "THuman", "--data_root",
            str(tmp_path / "missing"), "--mesh_devices", "2",
            "--batch_size", "2"])


def test_mesh_flags_not_divisible(tmp_path):
    with pytest.raises(ValueError, match="not divisible"):
        run_nerf_batch_torch.main(COMMON + [
            "--basedir", str(tmp_path), "--expname", "bad",
            "--mesh_devices", "4", "--batch_size", "3"])


def test_a_failing_rank_fails_the_launch():
    """Rank 1 raises while rank 0 waits in a collective: the launch
    terminates rank 0 and raises with rank 1's traceback."""
    with pytest.raises(RankFailed, match="fails on purpose"):
        spawn(fail_on_rank, 2, (1,), timeout_s=60, deadline_s=60)
