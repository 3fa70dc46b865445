"""Device operations (kernels, copies, sets) a step."""

from crt_bench.readers import ops_per_step as read  # noqa: F401
