"""Per-stage wall-clock timers + leveled debug channel.

Counterpart of the reference's tracing subsystem (SURVEY §5):
`ScopedTimerEvents` prints per-stage ms deltas and `TimerAvrg` keeps
moving-average stage times (src/basictypes/timers.h:32-76), gated by the
`Debug` singleton (debug.h:30-46) with its string-registry side channel
(`Debug::addString`, the `-dbg_str` CLI flags).

Host-side timers here bracket whole jitted dispatches (device work is
opaque inside); for kernel-level profiles use `profile_trace` which wraps
the jax profiler (the device equivalent of USE_TIMERS builds).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict


class _TimerAvrg:
    """Moving average (reference TimerAvrg, timers.h)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.total = 0.0
        self.n = 0
        self.last = 0.0

    def add(self, dt: float) -> None:
        self.last = dt
        # exponential window keeps O(1) state
        if self.n >= self.window:
            self.total -= self.total / self.window
        else:
            self.n += 1
        self.total += dt

    @property
    def avg(self) -> float:
        return self.total / max(self.n, 1)


class StageTimers:
    """Named stage timer registry; enabled cheaply (a perf_counter pair)."""

    def __init__(self):
        self.stages: OrderedDict[str, _TimerAvrg] = OrderedDict()
        self.enabled = True

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.setdefault(name, _TimerAvrg()).add(
                time.perf_counter() - t0
            )

    def add(self, name: str, dt: float) -> None:
        self.stages.setdefault(name, _TimerAvrg()).add(dt)

    def report(self, last: bool = False) -> str:
        """One-line 'stage=ms' summary (the |@# per-frame suffix)."""
        return " ".join(
            f"{k}={1e3 * (v.last if last else v.avg):.1f}ms"
            for k, v in self.stages.items()
        )

    def reset(self) -> None:
        self.stages.clear()


#: process-wide registry used by System/FrameExtractor/MapManager
timers = StageTimers()


class Debug:
    """Leveled debug singleton (reference debug.h:30-46)."""

    level = 0
    _strings: dict[str, str] = {}

    @classmethod
    def setLevel(cls, level: int) -> None:
        cls.level = level

    @classmethod
    def msg(cls, text: str, level: int = 5) -> None:
        if cls.level >= level:
            print(f"#DEBUG {text}", flush=True)

    @classmethod
    def addString(cls, key: str, value: str = "") -> None:
        """String-registry side channel (Debug::addString; -dbg_str)."""
        cls._strings[key] = value

    @classmethod
    def getString(cls, key: str, default: str = "") -> str:
        return cls._strings.get(key, default)

    @classmethod
    def isString(cls, key: str) -> bool:
        return key in cls._strings


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Dump a jax profiler trace (xplane) for the enclosed block — the
    Device-side equivalent of a USE_TIMERS build; view with xprof/tensorboard."""
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
