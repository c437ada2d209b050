"""Frozen operation and byte counts, and the card's peaks (``peaks.json``)."""
