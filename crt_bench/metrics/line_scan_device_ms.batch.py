"""Device ms a step of the work launched inside the port's
ntsc.demodulate.line_scan spans: the line scan: the rows in vsync order,
K3, the burst, K4 and the decode waves."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.demodulate.line_scan")
