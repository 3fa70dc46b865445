"""Device ms a step of the work launched inside pipeline.demodulate."""

from crt_bench.readers import span_device_ms


def read(tr):
    return span_device_ms(tr, "demodulate")
