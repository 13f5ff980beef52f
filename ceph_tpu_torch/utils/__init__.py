"""Host runtime helpers: layered config, perf counters, device choice."""

from .config import config  # noqa: F401
