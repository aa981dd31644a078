"""``device_idle.train``: the share of the traced window in which no
operation ran on the card: 1 - (the union of every device operation's
interval) / window."""

from benchmark.readers import device_idle as read  # noqa: F401
