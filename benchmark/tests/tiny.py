"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
narrow widths, small rooms and batches. Only the tests use it."""

from benchlib import common

WIDTHS = {
    "s3dis_stratified": dict(channels=[16, 32, 64, 128],
                             num_heads=[1, 2, 4, 8], depths=[1, 1, 2, 1]),
    "scannetv2_stratified": dict(channels=[16, 16, 32, 64, 64],
                                 num_heads=[1, 1, 2, 4, 4],
                                 depths=[1, 1, 1, 2, 1]),
}


def tiny_cell(name):
    cell = common.Cell(name)
    cell.config["yaml"].update(WIDTHS[cell.entry["config"]])
    if cell.spec["kind"] == "train":
        cell.config["yaml"].update(max_batch_points=4096, batch_size=2)
        cell.traffic.update(room_points=3000, room_extent=2.0,
                            points_per_room=1500)
    else:
        cell.config["yaml"].update(voxel_max=2000, batch_size_test=2)
        cell.traffic.update(room_points=3000, room_extent=2.0, passes=1)
    return cell
