"""Per-stream codecs: sequences, qualities and names."""
