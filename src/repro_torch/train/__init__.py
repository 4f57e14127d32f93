"""Serving steps of the port's LM path."""
