"""Streaming BEV helpers shared by occupancy and (later) online mapping."""
