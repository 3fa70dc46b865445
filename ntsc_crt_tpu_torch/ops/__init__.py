"""Integer ops, filters and gathers of the port."""
