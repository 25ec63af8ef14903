"""Host-clock spans around calls into the port, recorded from the
benchmark's own files: a method is wrapped on its instance (the class is
left alone), and wrapped again on the new instance after every
`System.reset`, which makes a new loop closer. With a profiler running
each span is also a user annotation in the trace, so that an idle gap of
the device can be named by what the host was doing.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class Spans:
    def __init__(self, annotate: bool = False):
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.annotate = annotate

    def wrap(self, obj, method: str, name: str) -> None:
        """Record a span `name` around every call of obj.method."""
        inner = getattr(obj, method)
        spans = self.spans[name]
        annotate = self.annotate

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                if annotate:
                    with torch.profiler.record_function(name):
                        return inner(*args, **kwargs)
                return inner(*args, **kwargs)
            finally:
                spans.append((t0, time.perf_counter()))

        setattr(obj, method, timed)

    def ms(self, name: str, t0: float = float("-inf"),
           t1: float = float("inf")) -> List[float]:
        """The durations in ms of the spans `name` that start in [t0, t1)."""
        return [1e3 * (b - a) for a, b in self.spans.get(name, ())
                if t0 <= a < t1]

