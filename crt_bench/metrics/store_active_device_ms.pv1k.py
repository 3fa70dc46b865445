"""Device ms a step of the work launched inside the port's
ntsc.modulate.store spans: K1's block of picture rows stored into the
field (fastpath.store_active)."""

from crt_bench.spans import program_span_device_ms


def read(tr):
    return program_span_device_ms(tr, "ntsc.modulate.store")
