"""Host milliseconds a frame of the VSS eval loop's post-processing
(``engine/inference.py``: the class map's argmax on the card, its download,
the evaluator), from the loop's own ``timings["post_s"]``, over the window's frames."""


def read(run):
    if getattr(run, "unit", None) != "frame" or not run.frames or "post_s" not in run.timings:
        return None
    return 1e3 * run.timings["post_s"] / run.frames
