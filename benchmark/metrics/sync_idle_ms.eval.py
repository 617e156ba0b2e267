"""Idle ms of the card per eval call in gaps that began inside one of the
program's spans during a synchronizing host call (a stream, device or
event synchronize, or a copy to pageable host memory): the host waited
for the card and then had nothing queued (`benchlib.spans`)."""

from benchlib import spans


def read(probe):
    if probe.kind != "eval":
        return None
    return spans.idle_ms(probe, "sync_idle_ms")
