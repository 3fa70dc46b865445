"""Device ms a step of the work launched inside the port's
ntsc.modulate.encode spans: K1 over the picture rows and their store
into the field (NES: K13)."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.modulate.encode")
