"""Operators of the port that carry a hand-written Hopper kernel."""
