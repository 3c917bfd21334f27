"""Device milliseconds a frame in the referring tracker (models/tracker/): CUDA events at the
benchmark's forward hooks on ``model.tracker``, summed over the traced
window's calls, over the window's frames."""


def read(run):
    span = run.spans.get("tracker", {})
    if getattr(run, "unit", None) != "frame" or not run.frames or "device_ms" not in span:
        return None
    return span["device_ms"] / run.frames
