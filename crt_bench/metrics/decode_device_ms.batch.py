"""Device ms a step of the work launched inside the port's
ntsc.demodulate.decode spans: K2 and its arguments."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.demodulate.decode")
