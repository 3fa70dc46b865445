"""The row placement's share of its byte floor (each decoded line read
once, the output written once), over the device time launched inside the
port's ntsc.demodulate.place spans, in %."""

from crt_bench.readers_nes import place_rows_roofline_pct as read  # noqa: F401
