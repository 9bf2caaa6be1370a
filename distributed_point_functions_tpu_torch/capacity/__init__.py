"""Byte and time models that size the port's serving work: dense PIR's
selection bytes and the heavy-hitters frontier (see `model.py`), priced
from measured throughput (`calibration.py`)."""
