"""Share (%) of the profiled stretch (whole videos inside the traced
window) in which no kernel, copy or memset ran on the card: one minus the
union of the device intervals over the stretch (``bench/trace.py``)."""


def read(run):
    tr = run.trace or {}
    if getattr(run, "unit", None) != "frame" or not tr.get("stretch_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["stretch_s"])
