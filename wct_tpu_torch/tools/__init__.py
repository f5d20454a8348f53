"""Measurement tools that run on the card."""
