"""Ingest (``data/prefetch.py``): the time the window's steps waited on the
prefetch pipeline (its ``prefetch_stall_s`` counter), in ms a step."""


def read(run: dict):
    if "prefetch_stall_s" not in run or not run["steps"]:
        return None
    return run["prefetch_stall_s"] * 1e3 / run["steps"]
