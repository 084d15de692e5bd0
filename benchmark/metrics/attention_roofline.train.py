"""``attention_roofline.train``: the least time of the model's attentions (two
score-sized products a query forward, four in the dx-only backward; causal
text queries over their earlier keys up to EOT) in a training step's traced
window, each the larger of its operations at the precision's peak and its
bytes (inputs read once, outputs written once) at 3.35 TB/s (``work.py``),
over the device time of every kernel whose name holds one of ``PATTERNS``,
the port's and any library's, in %.
"""

MODE = "train"
PATTERNS = ("attn", "attention", "fmha", "flash")


def read(run):
    return run.roofline("attention", PATTERNS)
