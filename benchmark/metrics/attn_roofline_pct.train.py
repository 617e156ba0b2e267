"""The attention calls' least time over their device time, in percent, on
the timed batch's own plans (`benchlib.probe.Probe.attention_roofline`):
forward and backward of the program's public attention Function alone."""


def read(probe):
    if probe.kind != "train":
        return None
    return 100.0 * probe.attention_roofline()
