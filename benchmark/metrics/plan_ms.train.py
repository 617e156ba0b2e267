"""Device ms per train step launched inside the plans' spans
(``st.stage<i>.plan``, the two ``build_attention_plan`` calls of each
stage), from a profiled window of the program's own spans
(`benchlib.spans`)."""

from benchlib import spans


def read(probe):
    if probe.kind != "train":
        return None
    return spans.plan_ms(probe)
