"""``gemm_roofline.serve``: the least time of the model's products (the towers'
projections and their dx, the patch embedding, the output projections, the
logits) in a request's traced window, each the larger of its operations at
the precision's peak and its bytes (inputs read once, outputs written once)
at 3.35 TB/s (``work.py``), over the device time of every kernel whose name
holds one of ``PATTERNS``, the port's and any library's, in %.
"""

MODE = "serve"
PATTERNS = ("gemm", "xmma", "cutlass", "cublas", "nvjet")


def read(run):
    return run.roofline("gemm", PATTERNS)
