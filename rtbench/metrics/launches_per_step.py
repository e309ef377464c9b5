"""Device kernels and memsets a step (the entry and wavefront layer's
launch count: every torch op and hand-written kernel the step enqueues)."""

from rtbench.trace import launches as read  # noqa: F401
