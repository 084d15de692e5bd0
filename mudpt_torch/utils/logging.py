"""Logging: stdout tee to ``<output_dir>/log.txt`` + structured JSONL metrics.

The reference relies on Dassl's ``setup_logger`` (reference train.py:159),
which tees stdout into ``log.txt``; offline aggregation then greps the text
logs.  We keep the text tee for compatibility with the sweep scripts and the
log parser, and additionally emit machine-readable JSONL metrics
(``metrics.jsonl``) so aggregation doesn't need to parse prose.  A copy of
``mudpt_tpu/utils/logging.py``; a rank other than the primary writes its
files with a ``-host<rank>`` suffix, so that ranks sharing an OUTPUT_DIR
never interleave on one file.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

from mudpt_torch.parallel.multihost import process_index


class _Tee:
    def __init__(self, stream, fh):
        self._stream = stream
        self._fh = fh

    def write(self, data):
        self._stream.write(data)
        self._fh.write(data)
        return len(data)

    def flush(self):
        self._stream.flush()
        self._fh.flush()

    def isatty(self):
        return False

    def close(self):
        # keep the underlying stream open (it's the process stdout); only
        # flush the tee file
        self._fh.flush()

    def fileno(self):
        return self._stream.fileno()


def _rank_suffix() -> str:
    """'' on the primary rank (and without a process group), else
    ``-host<rank>`` (``logging.py:55-60``)."""
    return f"-host{process_index()}" if process_index() > 0 else ""


def setup_logger(output_dir: Optional[str]) -> None:
    """Tee stdout/stderr to ``<output_dir>/log.txt`` (append); an earlier
    log is renamed with a timestamp, as Dassl rotates it."""
    if not output_dir:
        return
    os.makedirs(output_dir, exist_ok=True)
    suffix = _rank_suffix()
    path = os.path.join(output_dir, f"log.txt{suffix}")
    if os.path.exists(path):
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        try:
            os.rename(path, os.path.join(output_dir, f"log.txt{suffix}-{stamp}"))
        except OSError:
            pass
    fh = open(path, "a", buffering=1)
    sys.stdout = _Tee(sys.__stdout__, fh)
    sys.stderr = _Tee(sys.__stderr__, fh)


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, output_dir: Optional[str], filename: str = "metrics.jsonl"):
        self._fh = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, filename + _rank_suffix()), "a",
                            buffering=1)

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("time", time.time())
        if self._fh is not None:
            self._fh.write(json.dumps(record, default=float) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
