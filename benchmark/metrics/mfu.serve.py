"""``mfu.serve``: the model's operations in the untraced part of a traced run's
window (the vision tower and the logits of each request; s8 products at
1,979 TOP/s, the rest at 989 TFLOP/s, ``work.py``) over its time, in %.
"""

MODE = "serve"


def read(run):
    return run.mfu()
