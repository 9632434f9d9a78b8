"""Shared pieces of the benchmark's CPU tests: tiny overrides of each
cell, so that the harness runs end to end here in seconds."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "scenario_qp.b1024": {"config": {"n": 64, "m": 128, "factor_cols": 16},
                          "traffic": {"batch": 8, "pool": 2,
                                      "warmup_calls": 1, "trace_calls": 2}},
    "scenario_qp.b16": {"config": {"n": 64, "m": 128, "factor_cols": 16},
                        "traffic": {"batch": 4, "pool": 3,
                                    "warmup_calls": 1, "trace_calls": 2}},
    "dense_qp.single": {"config": {"n": 128, "m": 128, "factor_cols": 8},
                        "traffic": {"warmup_calls": 1, "trace_calls": 2}},
}
