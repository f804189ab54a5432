"""Serving runtime of the port: parameters, engine and slot scheduler."""
