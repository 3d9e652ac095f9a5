"""Small shared utilities: guidance combinators for model closures."""

from .guidance import classifier_free, interval_classifier_free, rescaled_classifier_free

__all__ = [
    "classifier_free",
    "interval_classifier_free",
    "rescaled_classifier_free",
]
