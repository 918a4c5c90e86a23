"""Labeled-graph generators."""
