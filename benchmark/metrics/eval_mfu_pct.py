"""Model FLOPs of the window's calls over (the window's wall seconds x the
H100's dense bf16 peak), in percent: the eval cells' whole-call share of
the card's peak (`benchlib.probe.Probe.mfu`; FLOPs per valid point of a
few batches, from the reference's plans, times the window's points)."""


def read(probe):
    if probe.kind != "eval":
        return None
    return 100.0 * probe.mfu()
