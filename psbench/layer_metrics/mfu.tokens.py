"""The hybrid LM step's share of the card's peak: model FLOPs (6 N_matmul a
token plus causal attention's needs; no recompute, no table) of the
window's steps over the window's time at the data-sheet peak of the math
mode float32 matmuls run in."""

from psbench import roofline


def read(run: dict):
    if "seq" not in run or not run["steps"] or run["device"]["platform"] != "gpu":
        return None
    flops = roofline.train_step_flops(run["config"], run["batch"], run["seq"]) * run["steps"]
    peak = roofline.peak_flops(run["device"]["kind"], run["math_mode"])
    return 100.0 * flops / (run["window_s"] * peak)
