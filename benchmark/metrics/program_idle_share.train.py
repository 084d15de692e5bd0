"""``program_idle_share.train``: the share of the traced window, in %, in
which the card idled while the program's own host path ran: a ``mudpt.*``
span open on the window's thread, or the backward of a span's ops being
dispatched (``benchmark/spans.py``).  The rest of ``idle_share.train`` is
the harness's: the loss, the optimizer, the loss's fetch.
"""

from benchmark import spans

MODE = "train"


def read(run):
    return spans.program_idle_share(run)
