"""The DeepSeek-V3 hybrid step's share of the card's peak: model FLOPs
(``psbench/roofline_moe.py``: the dense path, the held experts'
assignments the trainer counted on the card over the window, causal
attention; no recompute, no table) over the window's time at the
data-sheet peak of the math mode float32 matmuls run in."""

from psbench import roofline, roofline_moe


def read(run: dict):
    if "held_assignments" not in run or not run["steps"] or run["device"]["platform"] != "gpu":
        return None
    flops = roofline_moe.window_flops(run["config"], run["batch"], run["seq"], run["steps"],
                                      run["held_assignments"])
    peak = roofline.peak_flops(run["device"]["kind"], run["math_mode"])
    return 100.0 * flops / (run["window_s"] * peak)
