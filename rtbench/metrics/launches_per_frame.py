"""Device kernels and memsets a frame (the entry and wavefront layer's
launch count: every torch op and hand-written kernel the frame enqueues)."""

from rtbench.trace import launches as read  # noqa: F401
