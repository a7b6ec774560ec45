"""Process-wide metrics registry: Counter / Gauge / Histogram with labels
(a copy of ``repro.obs.metrics``, which imports no framework).

Everything is host-side and allocation-free on the hot path (fixed bucket
arrays, float adds). The trainer publishes its ``train_*`` gauges and
counters here, so one ``registry.snapshot()`` or
``registry.prometheus_text()`` covers the loop.

Histogram notes:

* ``quantile`` interpolates linearly *within* the winning bucket
  (prometheus ``histogram_quantile`` semantics); the overflow bucket
  interpolates up to the observed max.
* ``max`` is tracked from ``-inf`` so negative observations report their
  true maximum; the empty histogram still exposes ``0.0``.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def _label_suffix(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> Dict[str, float]:
        return {self.name: float(self.value)}


class Gauge:
    """Point-in-time value; ``fn`` makes it a callback gauge evaluated at
    snapshot time (how the ServingMetrics facade exposes its plain-int
    dataclass fields without changing any call site)."""

    __slots__ = ("name", "help", "value", "fn")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self.value = float(v)

    def get(self) -> float:
        if self.fn is not None:
            return float(self.fn())
        return self.value

    def snapshot(self) -> Dict[str, float]:
        return {self.name: self.get()}


class Histogram:
    """Fixed-bucket histogram (prometheus-style bucket upper bounds).

    Buckets are ``(-inf, b0], (b0, b1], ..., (b_{n-1}, +inf)``; the
    overflow count rides in ``counts[-1]``.
    """

    __slots__ = ("name", "help", "bounds", "counts", "total", "sum", "_max")

    def __init__(self, bounds: Sequence[float], name: str = "",
                 help: str = ""):
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        assert list(self.bounds) == sorted(self.bounds), \
            "histogram bounds must be sorted"
        self.counts = [0] * (len(self.bounds) + 1)  # last = +inf overflow
        self.total = 0
        self.sum = 0.0
        self._max = -math.inf

    def observe(self, x: float) -> None:
        i = 0
        for b in self.bounds:
            if x <= b:
                break
            i += 1
        self.counts[i] += 1
        self.total += 1
        self.sum += x
        if x > self._max:
            self._max = x

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0

    @property
    def max(self) -> float:
        """True observed maximum (``0.0`` when empty)."""
        return self._max if self.total else 0.0

    def quantile(self, q: float) -> float:
        """Linearly interpolated quantile estimate (0 < q <= 1).

        Within the winning bucket the value is interpolated between the
        bucket's lower and upper bound (the first bucket's lower bound is
        ``min(0, bounds[0])``, prometheus-style); a quantile landing in
        the overflow bucket interpolates between ``bounds[-1]`` and the
        observed max.
        """
        if not self.total:
            return 0.0
        target = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                frac = (target - seen) / c
                if i == 0:
                    lo = min(0.0, self.bounds[0]) if self.bounds else 0.0
                    hi = self.bounds[0] if self.bounds else self.max
                elif i < len(self.bounds):
                    lo, hi = self.bounds[i - 1], self.bounds[i]
                else:  # overflow: up to the true observed max
                    lo = self.bounds[-1] if self.bounds else 0.0
                    hi = max(self.max, lo)
                return lo + frac * (hi - lo)
            seen += c
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` (same bounds) into this histogram in place —
        multi-engine / multi-run aggregation."""
        assert self.bounds == other.bounds, \
            f"bucket mismatch: {self.bounds} vs {other.bounds}"
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum += other.sum
        if other.total and other._max > self._max:
            self._max = other._max
        return self

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, float]:
        p = prefix if prefix is not None else self.name
        return {
            f"{p}_mean": self.mean,
            f"{p}_p50": self.quantile(0.5),
            f"{p}_p99": self.quantile(0.99),
            f"{p}_max": self.max,
            f"{p}_count": float(self.total),
        }


class MetricsRegistry:
    """Names -> metric objects; get-or-create constructors, labeled
    children, one flattened ``snapshot()``, prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    # ------------------------------------------------------------ factories
    def _get_or_create(self, name: str, factory, kind) -> object:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                **labels) -> Counter:
        full = name + _label_suffix(labels)
        return self._get_or_create(full, lambda: Counter(full, help),
                                   Counter)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None,
              **labels) -> Gauge:
        full = name + _label_suffix(labels)
        g = self._get_or_create(full, lambda: Gauge(full, help, fn), Gauge)
        if fn is not None:
            g.fn = fn  # re-registration rebinds the callback (new facade)
        return g

    def histogram(self, name: str, bounds: Sequence[float],
                  help: str = "", **labels) -> Histogram:
        full = name + _label_suffix(labels)
        return self._get_or_create(
            full, lambda: Histogram(bounds, full, help), Histogram)

    def register(self, name: str, metric: object,
                 replace: bool = True) -> object:
        """Adopt an externally constructed metric (the ServingMetrics
        facade re-registers its histograms on each instantiation)."""
        with self._lock:
            if not replace and name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = metric
            return metric

    def unregister_prefix(self, prefix: str) -> None:
        with self._lock:
            for k in [k for k in self._metrics if k.startswith(prefix)]:
                del self._metrics[k]

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, float] = {}
        for name, m in items:
            if isinstance(m, Histogram):
                out.update(m.snapshot(name))
            else:
                out.update(m.snapshot())  # type: ignore[union-attr]
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4) dump."""
        with self._lock:
            items = list(self._metrics.items())
        lines: List[str] = []

        def base_and_labels(full: str) -> Tuple[str, str]:
            if "{" in full:
                i = full.index("{")
                return full[:i], full[i:]
            return full, ""

        for name, m in items:
            base, labels = base_and_labels(name)
            if isinstance(m, Counter):
                if m.help:
                    lines.append(f"# HELP {base} {m.help}")
                lines.append(f"# TYPE {base} counter")
                lines.append(f"{name} {m.value:g}")
            elif isinstance(m, Gauge):
                if m.help:
                    lines.append(f"# HELP {base} {m.help}")
                lines.append(f"# TYPE {base} gauge")
                lines.append(f"{name} {m.get():g}")
            elif isinstance(m, Histogram):
                if m.help:
                    lines.append(f"# HELP {base} {m.help}")
                lines.append(f"# TYPE {base} histogram")
                inner = labels[1:-1] if labels else ""
                cum = 0
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    lab = (inner + "," if inner else "") + f'le="{b:g}"'
                    lines.append(f"{base}_bucket{{{lab}}} {cum}")
                lab = (inner + "," if inner else "") + 'le="+Inf"'
                lines.append(f"{base}_bucket{{{lab}}} {m.total}")
                lines.append(f"{base}_sum{labels} {m.sum:g}")
                lines.append(f"{base}_count{labels} {m.total}")
        return "\n".join(lines) + "\n"

    def dump_prometheus(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.prometheus_text())
        return path


# ------------------------------------------------------------ global registry
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (orchestrator, serving facade, trainer,
    and benchmarks all publish here)."""
    return _REGISTRY
