"""Device ms per train step launched inside the optimizer's span
(``st.optimizer``: the scheduled AdamW update, and the clip where the
configuration sets ``max_grad_norm``), from a profiled window of the
program's own spans (`benchlib.spans`)."""

from benchlib import spans


def read(probe):
    if probe.kind != "train":
        return None
    return spans.span_dev_ms(probe, "st.optimizer")
