"""Structured metrics logging (port of ``utils/metrics.py``).

JSON-lines records, one object per event, stamped with the seconds since
the logger was made and the wall clock, for unattended renders: the CLI's
``--metrics`` and ``render/progressive.py``'s scheduler write them.
"""

from __future__ import annotations

import io
import json
import pathlib
import sys
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL event log.

    Every record carries ``event`` (str), ``t`` (seconds since the logger
    was made) and ``wall`` (unix time); the caller adds the other fields.
    Values are coerced with ``float()``/``int()`` where they allow it, so no
    tensor reaches the file.  ``path=None`` logs to stderr.
    """

    def __init__(self, path: Optional[str] = None):
        self._t0 = time.time()
        if path is None:
            self._fh: io.TextIOBase = sys.stderr
            self._own = False
        else:
            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(p, "a", buffering=1)  # line-buffered
            self._own = True

    @staticmethod
    def _coerce(v):
        if isinstance(v, (str, bool, type(None))):
            return v
        if isinstance(v, int):
            return v
        try:
            f = float(v)
            return int(f) if float(f).is_integer() and abs(f) < 2**53 else f
        except (TypeError, ValueError):
            return str(v)

    def log(self, event: str, **fields) -> dict:
        rec = {
            "event": event,
            "t": round(time.time() - self._t0, 4),
            "wall": round(time.time(), 3),
        }
        rec.update({k: self._coerce(v) for k, v in fields.items()})
        self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
