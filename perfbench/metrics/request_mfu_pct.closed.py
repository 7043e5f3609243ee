"""The whole request's share of the chip's peak: least chip time of the
products completed in the window over the window's length."""
from perfbench.readers import request_mfu_pct as read  # noqa: F401
