"""Device ms of the on-device geometry (``stem_neighbors`` and
``geometry_pyramid``) on the timed batch, timed alone
(`benchlib.probe.Probe.geometry_ms`)."""


def read(probe):
    if probe.kind != "eval" or probe.geometry is None:
        return None
    return probe.geometry_ms()
