from .schedule import HorizonSchedule, build_schedule  # noqa: F401
