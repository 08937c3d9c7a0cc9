"""Aggregate wall-clock phase timer; the port's copy of
lightgbmv1_tpu/utils/timer.py.

The counterpart of the reference's ``Common::Timer`` / ``FunctionTimer``
fed by a global ``global_timer`` (include/LightGBM/utils/common.h:
1054-1138): a context manager that sums wall time per named phase while
``enabled`` and prints a sorted report.  The CLI enables it at
``verbosity >= 1`` and logs the report at exit; the boosting loop
(models/gbdt.py) opens its scopes (``GBDT::TrainOneIter``,
``GBDT::EvalTrain``, ``GBDT::EvalValid``, ...).  The timer reads the
host clock and adds no device synchronization: a scope that launches
device work times its enqueue, and the device time lands in the scope
that next reads a result back.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class Timer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.enabled = False

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["LightGBM-TPU timer report:"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {total:.3f}s ({self.counts[name]} calls)")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


global_timer = Timer()
