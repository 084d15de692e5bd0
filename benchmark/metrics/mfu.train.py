"""``mfu.train``: the model's operations in the untraced part of a traced run's
window (both towers forward and dx-only backward, the logits; s8 products at
1,979 TOP/s, the rest at 989 TFLOP/s, ``work.py``) over its time, in %.
"""

MODE = "train"


def read(run):
    return run.mfu()
