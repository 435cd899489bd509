"""The program entries a traffic mix names (``"entry"``): each a module
with ``Cell``, ``reference_family`` and ``reference_records``."""
