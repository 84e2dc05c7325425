"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

One :class:`MetricsRegistry` per component (executor, activation store,
update gate, benchmark harness) replaces the scattered ad-hoc counter
attributes those components grew organically.  Design constraints:

* **no deps** — percentiles come from fixed exponential buckets with
  linear interpolation inside the bucket, not from kept samples;
* **pure bookkeeping** — instruments never feed control flow, so a
  registry-backed run is bit-identical to the ad-hoc-counter run it
  replaced (the components keep their legacy attribute names as
  read-only properties over the instruments);
* **JSON-able** — :meth:`MetricsRegistry.snapshot` is what
  ``BENCH_*.json`` writers embed, :meth:`dump_line` is the periodic
  ``--metrics-every`` one-liner, :meth:`write_jsonl` appends a final
  snapshot line for log scrapers.

A copy of the JAX package's ``obs/metrics.py`` (the port imports nothing
of that package); the port's ``RoundExecutor`` keeps its counters here.
"""
from __future__ import annotations

import json
import math

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotone (float) counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n

    def snapshot(self):
        v = self.value
        return int(v) if float(v).is_integer() else float(v)


class Gauge:
    """Set/adjustable level with peak tracking (high-water marks)."""

    __slots__ = ("value", "peak")

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if self.value > self.peak:
            self.peak = self.value

    def add(self, dv: float) -> None:
        self.set(self.value + dv)

    def snapshot(self) -> dict:
        return {"value": self.value, "peak": self.peak}


class Histogram:
    """Fixed exponential-bucket histogram with interpolated percentiles.

    Buckets span ``[lo, hi]`` with ``growth``× geometric spacing plus an
    underflow and an overflow bucket; exact count/sum/min/max ride along
    so means are exact and only the percentiles are bucket-quantized
    (relative error bounded by ``growth - 1`` per estimate).
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 growth: float = 1.6):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(
                f"need 0 < lo < hi and growth > 1, got {lo}, {hi}, {growth}")
        n = int(math.ceil(math.log(hi / lo, growth))) + 1
        self.bounds = [lo * growth ** i for i in range(n)]   # upper edges
        self.counts = [0] * (n + 1)                          # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, p: float) -> float:
        """p in [0, 100] — linear interpolation inside the landing bucket,
        clamped to the observed [min, max] envelope."""
        if self.count == 0:
            return 0.0
        target = (p / 100.0) * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c and seen + c >= target:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (target - seen) / c
                est = lo + (hi - lo) * frac
                return float(min(max(est, self.min), self.max))
            seen += c
        return float(self.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Named instruments, get-or-create, one flat namespace.

    Naming convention (see EXPERIMENTS.md §Observability):
    ``<component>.<noun>[_<unit>]`` — e.g. ``exec.hidden_host_s``,
    ``store.spills``, ``gate.rejected.norm_fence``, ``bench.us.fedoptima``.
    """

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # -- get-or-create ----------------------------------------------------
    def counter(self, name: str) -> Counter:
        self._check_free(name, self._counters)
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        self._check_free(name, self._gauges)
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, **kw) -> Histogram:
        self._check_free(name, self._histograms)
        if name not in self._histograms:
            self._histograms[name] = Histogram(**kw)
        return self._histograms[name]

    def _check_free(self, name: str, own: dict) -> None:
        for kind, d in (("counter", self._counters),
                        ("gauge", self._gauges),
                        ("histogram", self._histograms)):
            if d is not own and name in d:
                raise ValueError(
                    f"metric {name!r} already registered as a {kind}")

    # -- export -----------------------------------------------------------
    def snapshot(self) -> dict:
        out: dict = {}
        if self._counters:
            out["counters"] = {k: c.snapshot()
                               for k, c in sorted(self._counters.items())}
        if self._gauges:
            out["gauges"] = {k: g.snapshot()
                             for k, g in sorted(self._gauges.items())}
        if self._histograms:
            out["histograms"] = {k: h.snapshot()
                                 for k, h in sorted(self._histograms.items())}
        return out

    def dump_line(self, prefix: str = "") -> str:
        """Compact one-line ``k=v`` rendering (the --metrics-every dump)."""
        parts = []
        for k, c in sorted(self._counters.items()):
            parts.append(f"{k}={c.snapshot()}")
        for k, g in sorted(self._gauges.items()):
            parts.append(f"{k}={g.value:g}(peak={g.peak:g})")
        for k, h in sorted(self._histograms.items()):
            if h.count:
                parts.append(f"{k}:p50={h.percentile(50):.3g}"
                             f",p99={h.percentile(99):.3g},n={h.count}")
        return (f"{prefix} " if prefix else "") + " ".join(parts)

    def write_jsonl(self, path: str, extra: dict | None = None) -> None:
        """Append one JSON line: the final snapshot (+ caller context)."""
        rec = dict(extra or {})
        rec["metrics"] = self.snapshot()
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
