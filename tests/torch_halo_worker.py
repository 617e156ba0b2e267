"""One rank of the sharded-inference tests of ``tests/test_torch_halo.py``,
run as

    python tests/torch_halo_worker.py <job.pt> <rank> <world> <port> <out dir>

It joins a gloo group of ``world`` CPU ranks at ``127.0.0.1:<port>`` (60 s
timeout), builds the job's model, makes its calls in order and writes
``<out dir>/rank<rank>.pt``: one record per call. A job (a dict written
with ``torch.save`` by the test) holds:

- ``"model"``: ``("stratified", StratifiedConfig fields, state dict)``, the
  model's `parallel.halo.block_predict`, or ``("window_mean", ws)``, a
  stand-in whose probabilities are each point's mean of its first three
  features over the valid points of its ``ws`` grid cell (a receptive field
  of one cell);
- ``"calls"``: ``(name, keyword arguments)`` with name ``"host"``
  (`parallel.halo.sharded_scene_probs`), ``"collective"``
  (`parallel.halo.sharded_scene_probs_collective`) or ``"scene"``
  (`eval.voting.evaluate_scene_sharded`, its log lines recorded), each on
  the job's ``coord`` / ``feat`` / ``num_classes``.

A call's record holds its probabilities (and labels), its stats, or the
exception it raised (type name, text and, for a halo-cap overflow, the
dropped count). The process imports neither JAX nor the JAX package.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stratified_transformer_torch.config import StratifiedConfig  # noqa: E402
from stratified_transformer_torch.eval import voting  # noqa: E402
from stratified_transformer_torch.models.stratified import (  # noqa: E402
    Stratified)
from stratified_transformer_torch.parallel import halo, mesh  # noqa: E402

TIMEOUT_S = 60


def window_mean(ws):
    """The stand-in block forward of `window_mean`'s description."""
    def predict(feats, xyz, offsets):
        valid = torch.arange(xyz.shape[0]) < offsets[-1]
        cells = torch.floor(xyz / ws).long()
        _, cell = torch.unique(cells, dim=0, return_inverse=True)
        same = (cell[:, None] == cell[None, :]) & valid[None, :]
        same = same.to(torch.float32)
        count = same.sum(1, keepdim=True).clamp_min(1)
        return (same @ feats[:, :3]) / count
    return predict


def make_predict(spec):
    if spec[0] == "window_mean":
        return window_mean(spec[1])
    model = Stratified(StratifiedConfig(**spec[1]))
    model.load_state_dict(spec[2], strict=True)
    return halo.block_predict(model.eval())


def one_call(predict, job, name, kw):
    args = (predict, job["coord"], job["feat"], job["num_classes"])
    stats, lines = {}, []
    try:
        if name == "scene":
            pred, probs = voting.evaluate_scene_sharded(
                *args, device="cpu", stats=stats, log=lines.append, **kw)
            return {"pred": pred, "probs": probs, "stats": stats,
                    "log": lines}
        fn = {"host": halo.sharded_scene_probs,
              "collective": halo.sharded_scene_probs_collective}[name]
        return {"probs": fn(*args, device="cpu", stats=stats, **kw),
                "stats": stats}
    except (halo.CoreSlabOverflow, halo.HaloCapOverflow) as e:
        return {"error": type(e).__name__, "text": str(e), "stats": stats,
                "dropped": getattr(e, "dropped", None)}


def main(job_path, rank, world, port, out):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    mesh.init_group(rank, world, "cpu", port, timeout_s=TIMEOUT_S)
    try:
        predict = make_predict(job["model"])
        result = [one_call(predict, job, name, kw)
                  for name, kw in job["calls"]]
    finally:
        torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    path, r, w, p, o = sys.argv[1:]
    main(path, int(r), int(w), int(p), o)
