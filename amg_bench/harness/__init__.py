"""The harness: one run of one cell, and what its traced run reads."""
