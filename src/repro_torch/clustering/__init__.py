"""Clustering metrics of the port (numpy only)."""
