"""The traffic generator: the same seed gives the same arrays, another
seed other rooms of the same sizes; evaluation batches are the same for
every seed and only their order moves."""

import numpy as np

from benchlib import common, traffic
from tiny import tiny_cell


def _cfg(cell):
    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.eval.driver import eval_config
    from stratified_transformer_torch.utils.config import CfgNode
    y = CfgNode(cell.yaml)
    return (from_cfg(y) if cell.spec["kind"] == "train" else eval_config(y)), y


def test_train_batches_repeat_by_seed():
    cell = tiny_cell("s3dis-train")
    cfg, y = _cfg(cell)
    a = traffic.train_batches(cell.traffic, cfg, y, 2 ** 31 + 17)
    b = traffic.train_batches(cell.traffic, cfg, y, 2 ** 31 + 17)
    c = traffic.train_batches(cell.traffic, cfg, y, 2 ** 31 + 18)
    assert len(a) == cell.traffic["pool"]
    for x, z in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], z[k])
    assert not np.array_equal(a[0]["xyz"], c[0]["xyz"])
    # every seed, every batch: the same valid points
    per = cell.traffic["points_per_room"]
    rooms = cfg.n_pad // per
    assert {int(x["offsets"][-1]) for x in a + c} == {rooms * per}
    assert len({x["xyz"].tobytes() for x in a}) == len(a)


def test_eval_batches_are_seed_free_and_ordered_by_seed():
    cell = tiny_cell("s3dis-eval")
    cfg, y = _cfg(cell)
    a = traffic.eval_batches(cell.traffic, cfg, y)
    b = traffic.eval_batches(cell.traffic, cfg, y)
    assert [x["points"] for x in a] == [x["points"] for x in b]
    for x, z in zip(a, b):
        np.testing.assert_array_equal(x["xyz"], z["xyz"])
        assert x["points"] == int(x["offsets"][-1]) <= cfg.n_pad
    o1 = traffic.cycle_order(len(a), 5)
    assert sorted(o1) == list(range(len(a)))
    np.testing.assert_array_equal(o1, traffic.cycle_order(len(a), 5))


def test_full_size_rooms_have_enough_voxels():
    """The shipped traffic's rooms hold more voxels than the crop, so that
    every batch has the same size (a short room raises)."""
    for name in ("s3dis_train", "scannet_train"):
        t = common.load_json("traffic", name + ".json")
        voxel = 0.04 if name.startswith("s3dis") else 0.02
        aug = {} if name.startswith("s3dis") else None
        for seed in (0, 2 ** 31 + 5):
            rng = np.random.default_rng((seed, 0, 0))
            c, f, lab = traffic.raw_room(rng, t["room_points"],
                                         t["room_extent"], 13)
            room = traffic.prepare_room(
                c, f, lab, rng, voxel_size=voxel, feat_scale=255.0,
                points=t["points_per_room"], aug=aug)
            assert len(room["xyz"]) == t["points_per_room"]
