from .misc import normalize_percentile

__all__ = ['normalize_percentile']
