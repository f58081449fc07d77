"""The LR model step's share of the card's roofline: over the window, the
least time the steps could take (the larger of their operations over the
fp32 peak and their bytes over the memory peak, counted from each batch's
shape and unique slots) over the time they took."""

from psbench import roofline


def read(run: dict):
    if "unique_slots" not in run or not run["steps"] or run["device"]["platform"] != "gpu":
        return None
    n = run["steps"]
    unique = run["unique_slots"] / n  # the counts are linear in it
    least = roofline.least_time_s(roofline.lr_step_flops(run["batch"], run["nnz"], unique),
                                  roofline.lr_step_bytes(run["batch"], run["nnz"], unique),
                                  run["device"]["kind"], run["math_mode"])
    return 100.0 * least * n / run["window_s"]
