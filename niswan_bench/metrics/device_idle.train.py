"""The share of the profiled sub-window in which the card ran no kernel,
copy or memset (the union of their intervals against the sub-window)."""

from niswan_bench.lib.readers import idle_percent as read  # noqa: F401
