"""Evaluation helpers (counterpart of rwkvtts_tpu/eval/)."""
