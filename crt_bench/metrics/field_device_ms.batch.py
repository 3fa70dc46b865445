"""Device ms a step of the work launched inside the port's
ntsc.modulate.field spans: the field's skeleton, colour burst and
carrier tables, and VHS's sync kill."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.modulate.field")
