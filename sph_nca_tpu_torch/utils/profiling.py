"""The training metrics stream (counterpart of ``MetricsLogger`` in
``sph_nca_tpu/utils/profiling.py``; that file's platform, compile-cache and
trace helpers serve the JAX runtime and have no counterpart here).

``MetricsLogger`` appends one JSON object a line: ``step``, ``t`` (seconds
since the logger opened, to the millisecond) and the metrics given. Python
ints stay ints (the port's rows carry ``iter`` and ``steps``); every other
value becomes a float where it can, as in the JAX package, so a reader of
the JAX CLI's stream reads the port's.
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream (no file: every call is a no-op)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        if self._fh is None:
            return
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            if isinstance(v, int) and not isinstance(v, bool):
                rec[k] = v
                continue
            try:
                rec[k] = float(v)  # python, numpy and 0-d torch scalars
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
