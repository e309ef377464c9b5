"""Share of the traced steps' wall time in which the device ran nothing
(device layer), %."""

from rtbench.trace import idle_share as read  # noqa: F401
