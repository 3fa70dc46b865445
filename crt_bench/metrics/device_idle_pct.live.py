"""Share of the traced walls with no device operation running, in %."""

from crt_bench.readers import idle_pct as read  # noqa: F401
