"""Device milliseconds a frame in the temporal refiner (``models/refiner/``):
CUDA events around the benchmark's wrappers of ``model.refiner.embed_pass``
and ``model.refiner.mask_window``, summed over the traced window, over its frames."""


def read(run):
    spans = [run.spans.get(k, {}) for k in ("refiner", "refiner_masks")]
    if getattr(run, "unit", None) != "frame" or not run.frames or "device_ms" not in spans[0]:
        return None
    return sum(s.get("device_ms", 0.0) for s in spans) / run.frames
