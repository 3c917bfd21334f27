"""Share (%) of its roofline at which the ViT trunk's attention runs (each
block's ``attn``: the qkv projection, ``ops/flash_attn.py`` -> 
``csrc/flash_attn_fwd.cu``, the output projection): the least time of the
profiled stretch's calls (``work/counts.py``, H100 published peaks) over the
device time of the kernels launched inside the benchmark's ``vit_attention``
ranges."""


def read(run):
    t = (run.trace or {}).get("range_device_s", {}).get("vit_attention")
    shapes = run.stretch_shapes.get("vit_attention") if hasattr(run, "stretch_shapes") else None
    if not t or not shapes:
        return None
    return 100.0 * run.least_time_s(shapes) / t
