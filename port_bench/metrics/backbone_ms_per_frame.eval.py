"""Device milliseconds a frame in the ViT-Adapter backbone (models/backbones/vit_adapter.py): CUDA events at the
benchmark's forward hooks on ``model.backbone``, summed over the traced
window's calls, over the window's frames."""


def read(run):
    span = run.spans.get("backbone", {})
    if getattr(run, "unit", None) != "frame" or not run.frames or "device_ms" not in span:
        return None
    return span["device_ms"] / run.frames
