"""The device: the share of the traced stretch in which no operation ran
on the card (1 - the union of its operation intervals over the stretch)."""


def read(run: dict):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
