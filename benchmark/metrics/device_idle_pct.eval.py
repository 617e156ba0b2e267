"""1 - (the card's busy time per call, from a few profiled calls) / (the
window's wall time per call), in percent (`benchlib.probe.Probe.idle_share`)."""


def read(probe):
    if probe.kind != "eval":
        return None
    return 100.0 * probe.idle_share()
