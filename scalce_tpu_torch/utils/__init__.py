# Copy of scalce_tpu/utils/__init__.py (only the imports differ).
"""Logging, stats, and synthetic-data utilities."""
