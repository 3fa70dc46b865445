"""K1 encode_rows's share of its roofline, in %."""

from crt_bench.readers import roofline_pct


def read(tr):
    return roofline_pct(tr, "encode_rows")
