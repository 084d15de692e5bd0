"""``program_idle_share.serve``: the share of the traced window, in %, in
which the card idled while a ``mudpt.*`` span of the program was open on the
window's thread (``benchmark/spans.py``).  The rest of ``idle_share.serve``
is the harness's: the argmax, the answers' copy, the client loop.
"""

from benchmark import spans

MODE = "serve"


def read(run):
    return spans.program_idle_share(run)
