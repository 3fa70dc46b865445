"""Device ms a step of the work launched inside the port's
ntsc.demodulate.noise spans: the noise stage: K11, and on VHS K5 and
K12."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.demodulate.noise")
