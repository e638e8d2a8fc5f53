"""Measurement scripts for the card (each run with ``python -m``)."""
