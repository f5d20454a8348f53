"""Measurement tools that run on the card, and ``make_bundle``, which
assembles a weight bundle on the host."""
