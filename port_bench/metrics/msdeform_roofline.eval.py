"""Share (%) of its roofline at which the deformable attention runs
(``ops/msdeform.py`` -> ``csrc/msdeform_fwd.cu``, and the four projections of
every ``MSDeformAttn``, in the pixel decoder and the ViT-Adapter's
extractors): the least time of the profiled stretch's calls (their
operations and bytes from their shapes, ``work/counts.py``, against the
H100's published peaks) over the device time of the kernels launched inside
the benchmark's ``msdeform`` ranges."""


def read(run):
    t = (run.trace or {}).get("range_device_s", {}).get("msdeform")
    shapes = run.stretch_shapes.get("msdeform") if hasattr(run, "stretch_shapes") else None
    if not t or not shapes:
        return None
    return 100.0 * run.least_time_s(shapes) / t
