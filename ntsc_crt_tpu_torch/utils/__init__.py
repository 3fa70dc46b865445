"""Helpers around the pipeline."""
