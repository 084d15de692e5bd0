"""The benchmark of ``mudpt_torch``, the PyTorch/CUDA port of MuDPT: MuDPT
prompt-tuning steps and cached-text serving on one H100.  ``run.py`` runs
one cell; ``calibrate.py`` reads the comparison's numbers over many seeds,
with the control and the faults, for its limits."""
