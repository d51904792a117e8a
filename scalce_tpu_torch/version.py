# Copy of scalce_tpu/version.py (only the imports differ).
__version__ = "0.1.0"

# The on-disk container format version lives in scalce_tpu/container.py
# (VERSION) next to the framing code that writes/checks it.
