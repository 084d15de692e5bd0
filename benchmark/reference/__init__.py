"""The plain references the benchmark holds the port to; they import
nothing of ``mudpt_torch`` and take nothing the port made."""
