"""Command-line tools (reference: tools/ — im2rec)."""
