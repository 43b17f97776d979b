"""1 - the union of device activity over the traced window of tracing
requests, in %: the host's decode between replays shows here."""

from perfbench.metrics._device import idle_pct as read  # noqa: F401
