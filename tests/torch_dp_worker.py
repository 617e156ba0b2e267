"""One rank of the data-parallel tests of ``tests/test_torch_dp.py``, run as

    python tests/torch_dp_worker.py <job.pt> <rank> <world> <port> <out dir>

It joins a gloo group of ``world`` CPU ranks at ``127.0.0.1:<port>`` (60 s
timeout), runs the job and writes ``<out dir>/rank<rank>.pt``. Jobs
(dicts written with ``torch.save`` by the test):

- ``"bn"``: a SyncBN `MaskedBatchNorm` in training mode on this rank's
  ``x``/``valid``, backward from ``sum(y * cot)``: the output, the input's
  and the parameters' gradients, the buffers;
- ``"step"``: ``steps`` data-parallel train steps
  (`parallel.dp.make_dp_train_step`) of the model of ``cfg`` (a
  `StratifiedConfig`'s fields) from ``state`` on this rank's host batch:
  each step's psum'd packed statistics, and after the last the parameters,
  buffers, gradients (averaged and clipped) and AdamW moments.

`fail_on_rank_one` and `wait_forever` are `parallel.mesh.spawn` targets of
the failure tests. The process imports neither JAX nor the JAX package.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stratified_transformer_torch.config import StratifiedConfig  # noqa: E402
from stratified_transformer_torch.data.loader import to_device  # noqa: E402
from stratified_transformer_torch.models.layers import (  # noqa: E402
    MaskedBatchNorm)
from stratified_transformer_torch.models.stratified import (  # noqa: E402
    Stratified)
from stratified_transformer_torch.parallel import mesh  # noqa: E402
from stratified_transformer_torch.parallel.dp import (  # noqa: E402
    make_dp_train_step)
from stratified_transformer_torch.train import schedulers  # noqa: E402
from stratified_transformer_torch.train.state import (  # noqa: E402
    make_optimizer)

TIMEOUT_S = 60


def bn_job(job, rank):
    x = torch.tensor(job["x"][rank], requires_grad=True)
    bn = MaskedBatchNorm(x.shape[1], momentum=job["momentum"], sync=True)
    with torch.no_grad():
        for name in ("weight", "bias", "mean", "var"):
            getattr(bn, name).copy_(torch.from_numpy(job[name]))
    y = bn(x, torch.from_numpy(job["valid"][rank]))
    (y * torch.from_numpy(job["cot"][rank])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "mean": bn.mean.numpy(),
            "var": bn.var.numpy()}


def step_job(job, rank):
    model = Stratified(StratifiedConfig(**job["cfg"]))
    model.load_state_dict(job["state"], strict=True)
    model.train()
    schedule, _ = schedulers.from_config(job["schedule_cfg"], 2)
    opt = make_optimizer(model, schedule,
                         max_grad_norm=job.get("max_grad_norm"))
    step = make_dp_train_step(255, model.cfg.num_classes,
                              job.get("offset_weight", 1.0))
    batch = to_device(job["batches"][rank], "cpu")
    packed = [step(model, opt, batch, None).numpy()
              for _ in range(job["steps"])]
    names = {id(p): n for n, p in model.named_parameters()}
    return {"packed": packed,
            "state": {k: v.numpy() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.numpy()
                      for n, p in model.named_parameters()},
            "moments": {names[id(p)]: (s["exp_avg"].numpy(),
                                       s["exp_avg_sq"].numpy())
                        for p, s in opt.state.items()}}


def fail_on_rank_one(rank, port):
    """A `mesh.spawn` target of the failure tests: rank 1 raises while
    rank 0 waits for it at a barrier."""
    mesh.init_group(rank, 2, "cpu", port, timeout_s=TIMEOUT_S)
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()


def wait_forever(rank):
    """A `mesh.spawn` target that never ends by itself."""
    while True:
        time.sleep(1)


def main(job_path, rank, world, port, out):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    mesh.init_group(rank, world, "cpu", port, timeout_s=TIMEOUT_S)
    try:
        result = {"bn": bn_job, "step": step_job}[job["kind"]](job, rank)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    path, r, w, p, o = sys.argv[1:]
    main(path, int(r), int(w), int(p), o)
