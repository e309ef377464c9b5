"""Rays a second in a traced run's window, which closes before its traced
steps: W*H*spp of each step over the window's seconds, / 1e6 (entry and
wavefront layer; the window's rate, read beside the end-to-end metrics
because across runs it spreads with the host's speed)."""

from rtbench.trace import window_rate as read  # noqa: F401
