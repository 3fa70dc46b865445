"""Device ms a step of the work launched inside the port's
ntsc.demodulate.place spans: the row placement (K6)."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.demodulate.place")
