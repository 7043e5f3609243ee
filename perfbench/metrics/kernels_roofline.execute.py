"""Least chip time of the completed products over the device time of every
non-copy operation in the traced window (the kernels' roofline share)."""
from perfbench.readers import kernels_roofline as read  # noqa: F401
