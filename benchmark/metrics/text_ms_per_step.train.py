"""``text_ms_per_step.train``: device milliseconds a step of the operations
launched inside the program's ``mudpt.text`` span, forward and backward (the
backward's by the forward op it differentiates: ``benchmark/spans.py``).
"""

from benchmark import spans

MODE = "train"


def read(run):
    return spans.device_ms_per_unit(run, "mudpt.text")
