"""The samples a batch that BP did not decode and that OSD therefore
decodes: the engine's ``osd_invocations`` counter, as ``run_rate`` totals
it when the window closes, over the window's batches; nothing off the
card."""


def read(run):
    w = run.get("window")
    if run.get("device") != "cuda" or not w or not w["stamps"]:
        return None
    closing = w["totals"][len(w["stamps"]) - 1]
    return int(closing.osd_invocations) / len(w["stamps"])
