from .timer import TimerManager, timer
from .log import debug, info, error, set_level
from .silence import scoped_stderr_silence

__all__ = ["TimerManager", "timer", "debug", "info", "error", "set_level",
           "scoped_stderr_silence"]
