"""Host milliseconds a frame of the VSS loop's class-map download
(``engine/inference.py::run_vss_inference``: the uint8 maps' ``.cpu()``,
which waits for the card's queued work), from the loop's own
``timings["download_s"]`` (the program's span ``eval.download``), over the
window's frames."""


def read(run):
    if getattr(run, "unit", None) != "frame" or not run.frames or "download_s" not in run.timings:
        return None
    return 1e3 * run.timings["download_s"] / run.frames
