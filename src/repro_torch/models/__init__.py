"""Eager forwards of the port's sequence modules (counterpart of
``repro.models``)."""
