"""Byte models that size the port's serving work (see `model.py`)."""
