"""Host milliseconds a frame in the program's test loader (``data/build.py``
and ``data/mapper.py``: JPEG decode, resize, normalize, pad), on the
benchmark's clock around each ``next()`` of the loader, over the window's frames."""


def read(run):
    if getattr(run, "unit", None) != "frame" or not run.frames:
        return None
    return 1e3 * run.loader_s / run.frames
