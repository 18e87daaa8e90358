"""Minimal structured logger + metrics accumulator for training loops.

Copied from ``repro/utils/logging.py``; the log line format is the same.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Any


def log(msg: str, **kv: Any) -> None:
    parts = [msg] + [f"{k}={v}" for k, v in kv.items()]
    print("[repro] " + " ".join(parts), file=sys.stderr, flush=True)


@dataclass
class MetricsLog:
    """Append-only metrics log; one record per merge boundary / eval point."""

    records: list[dict] = field(default_factory=list)
    _t0: float = field(default_factory=time.perf_counter)

    def append(self, **kv: Any) -> None:
        rec = dict(kv)
        rec.setdefault("wall_s", time.perf_counter() - self._t0)
        self.records.append(rec)

    def column(self, key: str) -> list:
        return [r[key] for r in self.records if key in r]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.records, f, indent=1, default=float)

    @staticmethod
    def load(path: str) -> "MetricsLog":
        m = MetricsLog()
        with open(path) as f:
            m.records = json.load(f)
        return m

    def best(self, key: str, mode: str = "max"):
        col = self.column(key)
        if not col:
            return None
        return max(col) if mode == "max" else min(col)

    def time_to_accuracy(self, target: float, time_key: str = "virtual_time"):
        """First time at which accuracy >= target (the paper's headline metric)."""
        for r in self.records:
            if r.get("accuracy", -1.0) >= target:
                return r[time_key]
        return None
