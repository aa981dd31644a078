"""``device_idle.tta``: the share of the traced window in which no
operation ran on the card: 1 - (the union of every device operation's
interval) / window. A union, not a sum: two lanes' work overlaps."""

from benchmark.readers import device_idle as read  # noqa: F401
