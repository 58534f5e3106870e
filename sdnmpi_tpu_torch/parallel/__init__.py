"""Compat home of the multi-device oracle: see :mod:`.mesh`."""
