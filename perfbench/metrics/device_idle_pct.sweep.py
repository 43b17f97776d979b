"""The device's idle share of the traced window: 1 - the union of the
intervals of every device activity (kernels, copies, sets) / the window."""

from perfbench.metrics._device import idle_pct as read  # noqa: F401
