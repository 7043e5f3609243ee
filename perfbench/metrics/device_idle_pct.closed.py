"""Share of the traced window with no kernel and no copy on any stream."""
from perfbench.readers import device_idle_pct as read  # noqa: F401
