from .profiling import DeadlineMonitor, Timer, solves_per_second  # noqa: F401
