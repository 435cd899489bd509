from .visualization import normalize_attr, attr_to_subplot

__all__ = ["normalize_attr", "attr_to_subplot"]
