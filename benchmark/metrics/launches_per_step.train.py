"""``launches_per_step.train``: every kernel launch in the traced window over
the steps in it.
"""

MODE = "train"


def read(run):
    return run.launches_per_unit()
