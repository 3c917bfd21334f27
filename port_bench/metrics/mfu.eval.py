"""Share (%) of the H100's published bf16 peak (989 TFLOP/s) that the whole
eval step reaches: the operations of every video completed in the window
(the plain reference's count at the cell's shapes, ``work/flops.py``) over
the window's seconds times the peak."""
from port_bench.work.peaks import FLOPS


def read(run):
    if getattr(run, "unit", None) != "frame" or not run.done_flops or run.window_s <= 0:
        return None
    return 100.0 * run.done_flops / (run.window_s * FLOPS["bfloat16"])
