"""Device ms a step of the work launched inside the port's
ntsc.demodulate.bloom spans: each line's drawn width (bloom_line_width and
its width arithmetic) and the carrier tables rotated to each line's EQ
start."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.demodulate.bloom")
