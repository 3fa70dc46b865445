"""Host ms of a call into the port's step, device idle at the call."""

from crt_bench.readers import issue_ms as read  # noqa: F401
