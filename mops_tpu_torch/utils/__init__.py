from .timer import TimerManager, timer
from .log import debug, info, error, set_level

__all__ = ["TimerManager", "timer", "debug", "info", "error", "set_level"]
