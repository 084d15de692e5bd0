"""The port's serving tools (counterparts of ``tools/export_serving.py``,
``tools/predict.py`` and ``tools/bench_artifact.py``), each run as
``python -m mudpt_torch.tools.<name>``."""
