"""K13 nes_square's share of its roofline, in %."""

from crt_bench.readers_nes import nes_square_roofline_pct as read  # noqa: F401
