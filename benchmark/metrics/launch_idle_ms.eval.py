"""Idle ms of the card per eval call in gaps that began inside one of the
program's spans (``st.*``) while no synchronizing host call ran: the
host was still launching (`benchlib.spans`)."""

from benchlib import spans


def read(probe):
    if probe.kind != "eval":
        return None
    return spans.idle_ms(probe, "launch_idle_ms")
