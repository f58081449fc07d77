"""The hybrid embedding plane: the mean host wait for a step's rows
already on their way to the card (the trainer's ``hybrid.pull_wait``
span), in ms a step over the window."""


def read(run: dict):
    waits = run.get("pull_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
