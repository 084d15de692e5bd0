"""``idle_share.train``: the share of the traced window in which no kernel,
copy or fill ran on the device (the union of their intervals), in %.
"""

MODE = "train"


def read(run):
    return run.idle_share()
