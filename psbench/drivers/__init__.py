"""Drivers: one module an entry path of the program (``Driver``, ``RATE``)."""
