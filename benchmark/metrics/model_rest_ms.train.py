"""Device-busy ms of one train step (queued behind a sleep kernel) less the
attention calls' device ms timed alone on the same plans: the rest of the
model and autograd, its gathers' backward with it."""


def read(probe):
    if probe.kind != "train" or probe.busy_ms is None:
        return None
    return probe.busy_ms - sum(probe.attention_ms)
