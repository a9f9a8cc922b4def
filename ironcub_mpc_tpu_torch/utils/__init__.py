from .profiling import solves_per_second, span  # noqa: F401
