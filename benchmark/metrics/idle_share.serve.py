"""``idle_share.serve``: the share of the traced window in which no kernel,
copy or fill ran on the device (the union of their intervals), in %.
"""

MODE = "serve"


def read(run):
    return run.idle_share()
